#!/usr/bin/env python3
"""Drive the PyTorch port (msmctts_tpu_torch) on one GPU and check it.

    python3 chip_smoke.py [--out results.json]

Phases, each of which raises on failure:
  1. environment: the card's name and power limit; TF32 off;
  2. build the three CUDA kernel sources of msmctts_tpu_torch/csrc (one nvcc
     each, in parallel);
  3. each kernel against its plain PyTorch version on the card at the
     shapes its path gives it (CSMSC; serving at batch 4, frame bucket 512;
     training at batch 16, 400 frames), with kernel, plain and library-call
     times (CUDA events, median of repeated runs after warm-up; for the VQ
     functions also the device time per call from the profiler, every
     kernel of the call counted, at their paths' N and at one rank's rows
     of two, with the statistics kernel's plan) and the
     least time the card could take; the fused MRF layer's rows name the
     kernel body that ran and its plan (tile rows, ring stages, shared
     bytes); then the edge shapes: T of 1, one short of and one past a
     tile, not a multiple of it, B = 1, a halo wider than T; N = 1, 7, 9
     for the VQ search's groups of 8 rows;
  4. the autoencoder's analysis-synthesis on the committed trained CSMSC
     weights, checked against the same model on the CPU on a small input,
     and the kernels' launch counts on a batch of 256 and 448 frames;
  5. text -> wav at the full width of the CSMSC recipe (seeded acoustic
     model, trained autoencoder): the ``synthesize`` entry point once as a
     subprocess, a small request against the CPU, then ``predict`` on a
     batch of 4 requests with launch counts and per-batch times;
  6. training at the full width of the CSMSC autoencoder recipe: 2 warmup
     and 2 GAN steps of ``VQGANTrainer`` at batch 16 on seeded synthetic
     mel/wav (trained autoencoder, seeded discriminator), with launch
     counts, per-step times and peak memory; then the trained module, back
     in eval mode, against the CPU;
  7. one warmup and one GAN step from equal state on the card and on the
     CPU (2 short utterances, dropout 0, given window starts);
  8. the two sharded VQ functions on 2 ranks (processes) that share the
     card over gloo, at the train step's shapes, with a ragged split, a
     rank whose rows are all masked and a rank without rows: the kernel
     path against its plain version and against one rank on all rows;
     per-rank kernel time and the all-reduce's time;
  9. NCCL at world size 1: init, one raw all-reduce, the two functions and
     one train step through the group;
 10. data-parallel training: the steps of phase 6 on 2 ranks sharing the
     card (global batch 16, 8 rows each, dropout on) against phase 6's one
     rank; state bit-equal across ranks; launches and collectives per step;
 11. data-parallel inference: phase 5's batch of 4 through ``use_mesh`` on
     2 ranks against one rank;
 12. acoustic-model training at the full width of the CSMSC AM recipe:
     ``PredictorTrainer`` against the trained autoencoder of the fixture,
     4 steps at batch 64 (text bucket 96, frame bucket 768) on a seeded
     synthetic batch, dropout on, with per-step times, peak memory, the
     teacher's snap (2 ``vq_nearest`` launches per step) held against its
     plain version at its N, the teacher unchanged; one step on the card
     against the CPU; the ``train`` entry point (its main, in process: 2
     steps behind the feed's prefetcher, the teacher's 4 snaps counted) on a
     small corpus written here, then ``predict`` from its checkpoint;
 13. serving at the full width of the CSMSC AM recipe (phase 5's seeded
     predictor, the fixture's autoencoder): a ``BatchingEngine`` (batch 4,
     text length 256, frame cap 512) warmed over its 13 shapes; one
     streamed batch at chunk 64 held against the monolithic ``predict`` of
     the same batch and against the same stream on the CPU, with its
     launches (4 ``vq_nearest``, 36 ``fused_resblock_layer`` per window)
     and both kernels held against their plain versions at its shapes;
     then ``python -m msmctts_tpu_torch.serve`` as a subprocess answering
     16 requests (a quarter streamed) from 8 client threads, each held
     against the in-process engine, its ``/stats`` showing no cold shape,
     no kernel build, no error and coalesced batches;
 14. the QS-TTS family at the full width of its two recipes, on seeded
     weights and data: (a) the synthesizer's analysis-synthesis of a batch of
     4 (1024-dim embeddings, frame bucket 512, x200 at 16 kHz) with launches
     (2 ``vq_nearest``, 36 ``fused_resblock_layer``), first and warm times,
     real-time factor, both kernels held against their plain versions at
     this path's shapes, and a small input against the CPU; (b)
     ``EmbVQGANTrainer`` at batch 16 (bucket 384) through its supervised,
     decode and GAN phases (2 ``vq_nearest_stats`` per step, held against
     plain on one step's inputs at N = 1536 and 6144), per-phase times, peak
     memory, which tensors moved, the trained synthesizer saved; one step of
     each phase from equal state against the CPU (losses, indices,
     codebooks, batch statistics, parameters) on a small config that turns
     on the ECAPA encoder, pitch / energy and the prosody estimator; (c) ``NASynEmbFSTrainer`` at the predictor recipe's width,
     batch 64 (bucket 768), dropout on, (b)'s synthesizer as its teacher (2
     ``vq_nearest`` per step, held against plain at N = 12 288 and 49 152;
     teacher unchanged); (d) both recipes through the train entry point
     (``msmctts_tpu_torch.train.main``, behind the feed; the predictor's 2
     steps count the teacher's 4 snaps) on a corpus written here, and
     ``infer`` from the synthesizer's checkpoint, all in process;
 15. the ISTFT recipe (``examples/csmsc/configs/msmc_vq_gan_istft.yaml``) at
     full width and depth on seeded weights: (a) analysis-synthesis of a batch
     of 4 (bucket 512) with launches (2 ``vq_nearest``, 18
     ``fused_resblock_layer``), wav lengths of exactly 300 samples a frame,
     first and warm times, real-time factor, both kernels held against their
     plain versions at this path's shapes (kernel 5 at C = 256 / T = 3 072 and
     C = 128 / T = 15 360, with cuDNN's time and the 3xTF32 bound), a small
     input against the CPU; (b) ``VQGANTrainer`` at batch 16 (bucket 400,
     windows of 12 000 samples, which the decoder must emit exactly), 2
     warmup + 2 GAN steps, per-phase times, peak memory, 2
     ``vq_nearest_stats`` per step held against plain on one step's inputs;
     one warmup and one GAN step from equal state against the CPU; (c)
     ``predict`` through the CSMSC AM recipe (seeded) over (b)'s autoencoder
     (4 ``vq_nearest``, 18 MRF launches), ``predict_stream`` refused; (d) the
     recipe through the train entry point (2 steps, into the GAN phase,
     behind the feed; 4 ``vq_nearest_stats``) on a corpus written here, and
     ``infer`` from its checkpoint (2 + 18 launches an utterance), in process;
 16. the int8 HiFi-GAN decoder on the trained fixture: (a) calibrated on the
     first batch it decodes; analysis-synthesis of a batch of 4 (bucket 512)
     against the fp32 decode (relative L2 below the JAX package's 0.05), 77
     int8 products per decode, each held bit-equal (int32) against its plain
     version at its site's shapes with its time beside cuDNN's fp32 conv and
     the int8 bound, int8 and fp32 decode times, the same int8 state on the
     CPU; (b) ``predict`` with the int8 decoder (phase 5's seeded AM) and one
     streamed batch at chunk 64 held against it; (c) ``python -m
     msmctts_tpu_torch.serve --int8`` as a subprocess under 8 clients (no
     cold shape, no kernel build, no error) and ``infer --int8`` on 3 lines;
 17. int8 fine-tuning and the quality tools on the fixture, over a seeded
     corpus of 16 utterances (221-400 frames) written here: (a) the QAT
     tool's precompute (2 ``vq_nearest`` + 36 ``fused_resblock_layer`` per
     utterance; both kernels held against plain at the longest one's
     shapes), 20 QAT steps at the tool's defaults (batch 8, windows of 64
     frames, lr 1e-5) with one calibration refresh (first / warm ms, peak
     memory, the fake-quant gap before and after, the fake-quant forward
     against the true int8 decode), one step card vs CPU, the written
     checkpoint through ``Int8Decoder`` (77 products bit-equal to plain,
     relative L2 against fp32 beside the fixture's PTQ), then the QAT tool's
     main with ``--steps 4`` and ``infer --int8`` of its output (2 + 77
     launches an utterance), in process; (b) the AS-MCD sweep over the
     fixture and (a)'s checkpoint against reference wavs that are the
     fixture's fp32 decode of the corpus's mel: fp32 (counted) and
     ``--int8`` on the card, fp32 on the CPU (within 0.01 dB of the card),
     in process; (c) ``debug_step`` and
     ``infer --debug``: indices against the plain snap, embeddings, wavs
     against the CPU; (d) the CSMSC AE recipe through ``train`` at batch 16
     for 2 steps with ``eval_inteval_iters: 2`` and a recording writer:
     ``evaluate`` once (2 + 36 launches), its wav against the
     analysis-synthesis of that row, nothing without a writer; a state
     stitched from the fixture's encoder and the QAT decoder;
 18. the LJSpeech recipes (``examples/ljspeech/configs/``) at full width and
     depth on seeded weights, 22.05 kHz with a 256-sample hop: (a)
     analysis-synthesis of a batch of 4 (512 / 448 / 389 / 300 frames, bucket
     512) with launches (2 ``vq_nearest``, 36 ``fused_resblock_layer``), wav
     lengths of exactly 256 samples a frame, first and warm times, real-time
     factor, both kernels held against their plain versions at this path's
     shapes (kernel 5 at T = 4 096 / 32 768 / 65 536 / 131 072 per row for C =
     256 / 128 / 64 / 32, with cuDNN's time and the 3xTF32 bound), a small
     input against the CPU; (b) ``VQGANTrainer`` at the recipe's batch 16 and
     windows of 11 264 samples from the fixture's encoder, quantizer and
     codebook under a seeded decoder, 2 warmup + 2 GAN steps with times and
     peak memory, kernel 2 held against plain on one step's inputs; one warmup and
     one GAN step (the recipe's UnivNet discriminator) from equal state
     against the CPU; (c) (b)'s checkpoint through ``python -m
     msmctts_tpu_torch.tools.strip_checkpoint --f16``, a seeded full-width
     LJSpeech AM over it, ``synthesize --static-frames 512`` (in process)
     against ``predict``, then ``tools.load_test --spawn`` driving ``python -m
     msmctts_tpu_torch.serve`` at batch 8 with 1, 4 and 16 clients (24
     requests each, 8 streamed probes; no error, no cold shape, no kernel
     build); (d) ``python -m msmctts_tpu_torch.train --profile DIR`` for 15
     steps on a corpus written here, whose trace must name kernel 2; (e) a
     reference-named checkpoint of seeded modules through
     ``tools.convert_torch_checkpoint`` and ``infer`` (in process) on the result against
     ``predict`` of the original modules;
 19. ``precision: bfloat16`` (the JAX package's policy: bf16-rounded weights,
     fp32 masters, codebooks and losses, every op in JAX's promoted dtype):
     (a) 2 warmup + 2 GAN steps of the CSMSC AE recipe at batch 16 (per-step
     times, peak memory, masters and codebooks fp32, kernel 2 held against
     plain on the first GAN step's inputs), then warm steps of the fp32 and
     the bf16 trainer in turns and one profiled GAN step of each, its device
     time split by the operand dtype of its convolution and matrix-product
     kernels; (b) the same for the AM recipe at batch 64, bucket 768 (the
     teacher in bf16, its 2 snaps held against plain, busy share); (c)
     ``predict`` of phase 5's batch of 4 from a checkpoint whose config asks
     for bf16: duration flips against fp32 with their rounding margins, then
     with fp32's durations the relative L2 against fp32's wav, 4 + 36
     launches, every snap and MRF layer of the call held against plain on
     its inputs; the daemon's engine (``serve.build_engine``) and HTTP
     handler over that checkpoint, in process, answering 4 requests (one
     streamed) against a bf16 engine, no cold shape, kernel build or error; (d) one bf16 step of each phase
     (AE warmup, AE GAN, AM) from equal state, card vs CPU;
 20. the model options no shipped recipe sets and the int8 decoder under
     bf16: (a) ``--int8`` under ``precision: bfloat16`` on the fixture:
     analysis-synthesis of a batch of 4 (bucket 512; 2 ``vq_nearest``, 77
     int8 products, no MRF kernel), every product bit-equal to plain and every
     snap equal to plain on the path's inputs, relative L2 against the fp32
     int8 and the bf16 float decodes, bf16 and fp32 int8 decode times in
     turns, the bf16 int8 state card vs CPU; ``predict`` of phase 5's batch
     with fp32's durations against the fp32 int8 predict; (b) the CSMSC AE
     recipe with ``norm: True``, ``upsampling: residual`` and ``restart_dead``
     (the fixture's encoder and codebook, half of each head's counts zeroed):
     2 warmup + 2 GAN steps at batch 16 (kernel 2 twice a step, held against
     plain), how many codewords the first step restarts, the batch statistics
     moved and saved, one step card vs CPU, the checkpoint's
     analysis-synthesis in ``residual`` and ``mapping`` modes (2 + 36
     launches, held against plain); (c) the legacy ``TTS`` task with a
     stand-in acoustic model (the port's ``Encoder``): its autoencoder ending
     over the fixture and its vocoder ending (the CSMSC recipe's HiFi-GAN),
     in process with launches and kernels against plain, then ``infer``'s
     main, in process, against the in-process output;
 21. the train feed and exported artifacts: (a) two synthetic corpora at the
     CSMSC recipes' shapes written to a temporary directory (64 utterances of
     221-400 frames with 24 kHz 16-bit PCM, 64 of 240-760 frames with phones
     and durations); the AE (batch 16) and AM (batch 64) datasets read in
     bulk by the native reader and file by file, in turns, and through the
     recipe's DataLoader, in batches per second (the native reader must be
     taken); ``train()`` of the AE recipe, 5 steps a run from one state,
     with ``device_prefetch`` 2 / 0 and ``wire_compression`` true / false /
     "full", in turns, with the loop time of each step, kernel 2 twice a
     step (held against plain on the last step's inputs), and the runs on
     the int16 wire against those without it (losses, codebook after step
     5) within ``WIRE_NOISE_X`` times the spread of one setting's two runs;
     (b)
     phase 5's serving weights exported at batch 4, text buckets 64 / 128 and
     512 frames for cuda (seconds per program), phase 5's batch through the
     artifact in process (4 ``vq_nearest`` + 36 ``fused_resblock_layer``,
     each held against plain) and in a fresh process that imports no model
     module, both against ``predict`` at 512 static frames (frames equal,
     wav within ``AS_TOL``); an ``--int8`` artifact (4 + 77 int8 products, no
     MRF kernel, each product bit-equal to plain) against the int8
     ``predict``; ``python -m msmctts_tpu_torch.serve --artifact`` answering
     4 requests, each equal to an in-process engine on the artifact (no cold
     shape, kernel build or error); ``predict`` warm with the wrappers'
     direct launches against every wrapper through its ``msmctts::``
     operator, in turns, and the host time of one ``vq_nearest`` call both
     ways. ``--feed-ab`` runs only a longer A/B of the feed (phase 1, then
     ``train()`` with the default feed, no prefetch, the loop's feed before
     the prefetcher and prefetch without the wire, 12 steps a run, 4 turns);
 22. orbax snapshots (``checkpoint_backend: orbax``): (a) ``train()`` of the
     CSMSC AE recipe at batch 16 from phase 6's state (the fixture's
     autoencoder, a seeded discriminator) for 1 warmup and 1 GAN step on a
     corpus written to a temporary directory, its final save a snapshot
     written by the port's own writer on a worker thread: the snapshot's
     size against a pickle of the same state, the train thread's stall in
     ``save()``, the writer's seconds and MB/s; (b) the snapshot read back
     (every leaf bit-equal to what was saved, MB/s), a fresh trainer resumed
     from it and one from the pickle (both states bit-equal to what was
     saved), then one GAN step from each with deterministic algorithms:
     metrics bit-equal, 2 ``vq_nearest_stats`` a step held against plain;
     (c) phase 5's serving weights written as snapshots (the fixture's
     autoencoder, the seeded AM over it) through ``infer`` in process, its
     wav bit-equal to ``infer`` of the pickles, 4 ``vq_nearest`` and 36
     ``fused_resblock_layer`` launches a batch, each held against plain;
 24. CUDA graphs of the GAN step, at the tiny width of the CPU tests and at
     the CSMSC recipe's (batch 16, frame bucket 1024, 0.5 s windows, the
     recipe's dropout), each from one state after one step at the shape
     (its first sight, eager): the benchmark's 3 checked steps eager,
     graphed (the capture and two replays) and graphed again after the
     benchmark's restore (weights loaded in place, each optimizer's state
     before any update, the generator's state); every
     dropout mask equal to eager's, the losses, first-gradient norms and
     changes within the benchmark's train limits, one capture a shape; the
     graphed and eager step times in turns and the memory peaks;
 25. one JSON line describing each kernel;
 26. last line: {"ok": true, "device": {...}}.

NCCL refuses two ranks on one device, so the two-rank phases use gloo, which
moves CUDA tensors through host memory; the log names the backend. Their
step times are those of two processes time-slicing one
card: no scaling figure. A rank that fails, dies or hangs fails the run.

It exits non-zero, printing no result, without a CUDA device or without
the rest of the repository. ``--out`` also profiles one warm ``predict``,
one warm GAN step, one warm AM step, one streamed batch, phase 14's
analysis-synthesis, GAN step and predictor step, phase 15's
analysis-synthesis and GAN step, phase 16's int8 decode and phase 17's QAT
step (device time by kernel, busy share) and writes every measurement to a
JSON file.
"""

import argparse
import atexit
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "csmsc_ae_r5.f16.ckpt")
AM_YAML = os.path.join(ROOT, "examples", "csmsc", "configs", "msmc_vq_gan_am.yaml")
AE_YAML = os.path.join(ROOT, "examples", "csmsc", "configs", "msmc_vq_gan.yaml")
SMOKE_DIR = os.path.join(ROOT, "build", "msmctts_tpu_torch", "smoke")

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12

# the main path's shapes: CSMSC recipe, batch 4, frame bucket 512
B, FRAMES = 4, 512
VQ_H, VQ_D, VQ_K = 4, 64, 64
STAGES = [(256, 6), (128, 5), (64, 5), (32, 2)]  # (channels, upsample) per HiFi-GAN stage
RB_KERNELS, RB_DILATIONS = (3, 7, 11), (1, 3, 5)
VQ_TOL = {"quant_atol": 0.0, "index_tie_rel_gap": 1e-5}
# the train step's shapes: CSMSC recipe, batch 16, lengths up to the 400-frame bucket
TRAIN_B, TRAIN_FRAMES = 16, 400
# sums: up to ~1300 fp32 terms of size ~1 per cell, added in another order than
# the plain version's matmul; counts, idx and quant are held exactly
VQS_TOL = {"rtol": 1e-5, "atol": 2e-4}
RB_TOL = {"rtol": 2e-4, "atol": 2e-4}
# beside RB_TOL: the 3xTF32 products must stay in fp32's class (the fp32 SIMT kernel before them: 8.1e-6)
RB_MAX_ABS = 5e-5
AS_TOL = 5e-4  # wav, card vs CPU, as the CPU parity tests hold the port to JAX
# one train step, card vs CPU from equal state: losses relative, codebook absolute
# (cuDNN and the CPU's convs sum in other orders, through some 60 layers and a backward)
STEP_TOL = {"loss_rtol": 2e-3, "codebook_atol": 1e-4}
# the ECAPA encoder's BN running statistics, card vs CPU after one step: relative where
# |x| > 1; flax's variance E[x^2] - E[x]^2 cancels in fp32 where the mean is large
# against the spread, and the two devices' convs sum in other orders
BN_STATS_RTOL = 1e-3
# W ranks against one rank after several steps: an assignment may fall the other
# way only between two codewords this close (relative distance gap), and only so many may
DP_TOL = {"flip_rel_gap": 1e-3, "max_flips": 16, "last_codebook_atol": 1e-4}
# data x model ranks (tensor parallelism) against one rank: the model group's
# partial products are summed in another order, so the weights part from one
# rank's by more rounding each step; on the H100 four steps gave flips at gaps
# up to 2.3e-3 and untouched codewords up to 3.3e-4 from one rank's
TP_TOL = {"flip_rel_gap": 5e-3, "max_flips": 16, "last_codebook_atol": 1e-3}
WORLD = 2  # ranks of the data-parallel phases; they share the one card
BACKEND = "gloo"  # of those phases: NCCL refuses two ranks on one device
NVLINK_BYTES = 450e9  # per direction between two cards of one host (published)
RANKS_TIMEOUT_S = 300.0
# the AM step's shapes: CSMSC AM recipe, batch 64, 24-96 phones (text bucket 96),
# 240-760 frames (frame bucket 768)
AM_B, AM_TEXT, AM_FRAMES = 64, 96, 768
AM_PHONES, AM_LENGTHS = (24, 96), (240, 760)
AM_STEPS = 4


def log(*args):
    """A line of the run's output, after the wall-clock time (the same clock
    in the spawned ranks), so that every step's seconds can be read off."""
    now = time.time()
    print(f"{time.strftime('%H:%M:%S', time.localtime(now))}.{int(now * 10) % 10}", *args, flush=True)


def time_ms(fn, runs=10, reps=5, warmup=3):
    """Per-call time of ``fn()``: CUDA events around ``runs`` back-to-back
    calls, divided by ``runs``; the median of ``reps`` such windows."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / runs)
    return statistics.median(times)


def device_profile(fn, runs=20, windows=8):
    """Device time per call of ``fn()`` over windows of ``runs`` calls
    (torch.profiler), every kernel and fill it launches counted: what the card
    spends, where ``time_ms`` of a short kernel shows the wrapper's host time
    per call. -> {"ms", "launches" per call, "by_kernel": {name: ms per
    launch}}. Each kernel counts with its mean time over the launches the
    tracer kept. The tracer may drop launches, in some windows more than half
    of them (9 of 20 of a short snap's, three windows running), so windows are
    taken until every kernel seen has kept ``runs // 2`` launches in all, up to
    ``windows`` windows. A kernel that a window shows more than ``runs`` times
    launches more than once a call, which this function does not measure."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    kept = {}  # kernel name -> [launches kept, device ms]
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        rows = _device_rows(prof)
        over = [r for r in rows if r["count"] > runs]
        if over:
            raise AssertionError(f"profile of {runs} calls: kernels launched more than once a call: {over}")
        for r in rows:
            k = kept.setdefault(r["name"], [0, 0.0])
            k[0] += r["count"]
            k[1] += r["device_ms"]
        if kept and all(c >= runs // 2 for c, _ in kept.values()):
            break
    else:
        raise AssertionError(f"profile of {runs} calls in {windows} windows kept too few launches: {kept}")
    by_kernel = {name: ms / c for name, (c, ms) in kept.items()}
    return {"ms": sum(by_kernel.values()), "launches": len(by_kernel), "by_kernel": by_kernel}


def bound(bytes_moved, flops, peak_flops=PEAK_FP32):
    t_bytes, t_ops = bytes_moved / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------- phases


def phase_environment():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "nvidia-smi unavailable"
    name = torch.cuda.get_device_name(0)
    log(f"[1] card: {card}")
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, device 0: {name}, count {torch.cuda.device_count()}")
    from msmctts_tpu_torch.utils.device import exact_fp32

    exact_fp32()
    return {"nvidia_smi": card, "name": name, "count": torch.cuda.device_count()}


def phase_build():
    from msmctts_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    info = cuda_build.build(["vq_nearest", "vq_stats", "resblock"])
    wall = time.perf_counter() - t0
    for name, i in info.items():
        regs = [line.strip() for line in i["log"].splitlines() if "registers" in line or "spill" in line]
        log(f"[2] built {name} in {i['seconds']:.2f}s (cached={i['cached']}) {' | '.join(regs)}")
    log(f"[2] build wall {wall:.2f}s")
    return {"wall_s": wall, "libs": {n: i["seconds"] for n, i in info.items()}}


def _vq_case(gen, N, tie=False):
    x = torch.randn(N, VQ_H, VQ_D, device="cuda", generator=gen)
    e = torch.randn(VQ_H, VQ_D, VQ_K, device="cuda", generator=gen)
    if tie:
        e[:, :, 9] = e[:, :, 4]
        x[::2] = e[:, :, 4]
    return x, e


def _distances(x, e):
    """[N, H, K] squared distances of x [N, H, d] to embed [H, d, K], in float64."""
    x64, e64 = x.double(), e.double()
    return (x64 * x64).sum(-1, keepdim=True) - 2 * torch.einsum("nhd,hdk->nhk", x64, e64) + (e64 * e64).sum(1)


def _index_gaps(x, e, idx, ref_idx):
    """Where ``idx`` and ``ref_idx`` differ: the gap between the two chosen
    codewords' distances, relative to the distance (floor 1)."""
    differ = idx != ref_idx
    dist = _distances(x[differ.any(-1)], e)
    pick = lambda i: dist.gather(-1, i[differ.any(-1)].long()[..., None])[..., 0]
    d_a, d_b = pick(idx), pick(ref_idx)
    return ((d_a - d_b).abs() / d_b.abs().clamp_min(1.0))[differ[differ.any(-1)]]


def _hold_snap(what, x, e, idx, quant, ref_idx, ref_quant):
    """A snap against its plain version: indices equal, or different only
    between codewords at equal distance (``VQ_TOL``); codewords of the equal
    indices within ``VQ_TOL``. -> (max abs error of the codewords, mismatches)."""
    same = idx == ref_idx
    if not bool(same.all()):
        gap = float(_index_gaps(x, e, idx, ref_idx).max())
        if gap > VQ_TOL["index_tie_rel_gap"]:
            raise AssertionError(f"{what}: index mismatch with distance gap {gap:.3g}")
    err = float((quant - ref_quant)[same].abs().max()) if bool(same.any()) else 0.0
    if err > VQ_TOL["quant_atol"]:
        raise AssertionError(f"{what}: codeword rows differ by {err}")
    return err, int((~same).sum())


def phase_vq(gen):
    from msmctts_tpu_torch.ops import vq

    rows, worst_err, flips = [], 0.0, 0
    for label, N, tie in (("stage0", B * FRAMES // 4, False), ("stage1", B * FRAMES, False),
                          ("ragged", 2047, False), ("tie", 640, True),
                          ("one-row", 1, False), ("short-group", 7, False), ("group+1", 9, False)):
        x, e = _vq_case(gen, N, tie)
        idx, quant = vq.vq_nearest(x, e)
        ref_idx, ref_quant = vq.vq_nearest_plain(x, e)
        torch.cuda.synchronize()
        err, mismatches = _hold_snap(f"vq {label}", x, e, idx, quant, ref_idx, ref_quant)
        flips += mismatches
        if tie and not bool((idx[::2] == 4).all()):
            raise AssertionError("vq tie: the first of two equal codewords must win")
        worst_err = max(worst_err, err)
        row = {"label": label, "N": N, "mismatches": mismatches, "max_abs_err": err}
        if label.startswith("stage"):
            nbytes = (N * VQ_H * VQ_D * 2 + VQ_H * VQ_D * VQ_K + N * VQ_H) * 4
            flops = 2 * N * VQ_H * VQ_D * VQ_K + 3 * N * VQ_H * VQ_K
            row.update(
                ms=time_ms(lambda: vq.vq_nearest(x, e), runs=50),
                device_ms=device_profile(lambda: vq.vq_nearest(x, e))["ms"],
                plain_ms=time_ms(lambda: vq.vq_nearest_plain(x, e), runs=50),
                bound=bound(nbytes, flops),
                library_ms=None,  # no single PyTorch call computes argmin + gather per head
            )
        rows.append(row)
        log(f"[3] vq_nearest {label} N={N}: {json.dumps(row)}")
    # a predict launches it twice per stage: the predictor snap and the re-quant
    per_predict = {
        key: 2 * sum(r[key] for r in rows if r["label"].startswith("stage")) for key in ("ms", "device_ms", "plain_ms")
    }
    per_predict["bound_ms"] = 2 * sum(r["bound"][0] for r in rows if r["label"].startswith("stage"))
    return {"rows": rows, "max_abs_err": worst_err, "tie_flips": flips, **per_predict}


def phase_vq_stats(gen):
    """The statistics kernel at the train step's shapes: CSMSC batch 16,
    frame bucket 400 (N = 16*100 at the coarse stage, 16*400 at the fine
    one), a ragged N, a mask with whole tiles invalid, and a constructed tie."""
    from msmctts_tpu_torch.ops import vq

    rows, worst = [], 0.0
    cases = (("stage0", TRAIN_B * TRAIN_FRAMES // 4, False), ("stage1", TRAIN_B * TRAIN_FRAMES, False),
             ("ragged", 2047, False), ("tie", 640, True), ("one-row", 1, False),
             ("short-group", 7, False), ("group+1", 9, False))
    for label, N, tie in cases:
        x, e = _vq_case(gen, N, tie)
        mask = (torch.rand(N, device="cuda", generator=gen) < 0.8).float()
        mask[64:256] = 0.0  # three whole row tiles invalid
        if label == "ragged":
            mask[N - 40:] = 0.0  # the short last tile too
        idx, quant, counts, sums = vq.vq_nearest_stats(x, e, mask)
        idx2, quant2, counts2, sums2 = vq.vq_nearest_stats(x, e, mask)
        s_idx, s_quant = vq.vq_nearest(x, e)
        p_idx, p_quant, p_counts, p_sums = vq.vq_nearest_stats_plain(x, e, mask)
        torch.cuda.synchronize()
        if not (torch.equal(idx, idx2) and torch.equal(quant, quant2)
                and torch.equal(counts, counts2) and torch.equal(sums, sums2)):
            raise AssertionError(f"vq_stats {label}: two launches on the same input differ")
        if not (torch.equal(idx, s_idx) and torch.equal(quant, s_quant)):
            raise AssertionError(f"vq_stats {label}: idx/quant differ from the vq_nearest kernel")
        if not (torch.equal(idx, p_idx) and torch.equal(quant, p_quant)):
            raise AssertionError(f"vq_stats {label}: idx/quant differ from the plain version "
                                 f"({int((idx != p_idx).sum())} indices)")
        if tie and not bool((idx[::2] == 4).all()):
            raise AssertionError("vq_stats tie: the first of two equal codewords must win")
        if not torch.equal(counts, p_counts):
            raise AssertionError(f"vq_stats {label}: counts differ by {float((counts - p_counts).abs().max())}")
        if float(counts.sum()) != float(mask.sum()) * VQ_H:
            raise AssertionError(f"vq_stats {label}: counts do not sum to the valid rows")
        err = float((sums - p_sums).abs().max())
        if not torch.allclose(sums, p_sums, **VQS_TOL):
            raise AssertionError(f"vq_stats {label}: sums differ by {err}")
        worst = max(worst, err)
        row = {"label": label, "N": N, "valid": int(mask.sum()), "walkers": vq.stats_plan(N, VQ_D, VQ_K).walkers,
               "sums_max_abs_err": err}
        if label.startswith("stage"):
            valid = int(mask.sum())
            nbytes = (N * VQ_H * VQ_D * 2 + VQ_H * VQ_D * VQ_K + N + N * VQ_H + VQ_H * VQ_K + VQ_H * VQ_D * VQ_K) * 4
            # distances for every row; the statistics as the sparse sum they are
            flops = 2 * N * VQ_H * VQ_D * VQ_K + 3 * N * VQ_H * VQ_K + valid * VQ_H * (2 * VQ_D + 1)
            flat = (idx.long() + torch.arange(VQ_H, device="cuda") * VQ_K).reshape(-1)
            xm = (x * mask[:, None, None]).reshape(N * VQ_H, VQ_D)
            table = torch.zeros(VQ_H * VQ_K, VQ_D, device="cuda")
            dev = device_profile(lambda: vq.vq_nearest_stats(x, e, mask))
            if dev["launches"] > 2:
                raise AssertionError(f"vq_stats {label}: {dev['launches']} device operations per call: {dev['by_kernel']}")
            row.update(
                ms=time_ms(lambda: vq.vq_nearest_stats(x, e, mask), runs=50),
                # every kernel of the call, and the snap at the same N: what the first
                # takes beyond the second is its statistics (pass, partials, final sum)
                device_ms=dev["ms"], device_by_kernel=dev["by_kernel"], launches_per_call=dev["launches"],
                snap_device_ms=device_profile(lambda: vq.vq_nearest(x, e))["ms"],
                plain_ms=time_ms(lambda: vq.vq_nearest_stats_plain(x, e, mask), runs=50),
                bound=bound(nbytes, flops),
                library_ms=None,  # no single PyTorch call computes argmin, gather and both sums
                # the closest single call: the sums alone, from given indices
                index_add_ms=time_ms(lambda: table.zero_().index_add_(0, flat, xm), runs=50),
            )
            row["beyond_snap_ms"] = row["device_ms"] - row["snap_device_ms"]
        rows.append(row)
        log(f"[3] vq_nearest_stats {label} N={N}: {json.dumps(row)}")
    staged = [r for r in rows if r["label"].startswith("stage")]
    per_step = {key: sum(r[key] for r in staged)
                for key in ("ms", "device_ms", "snap_device_ms", "beyond_snap_ms", "plain_ms", "index_add_ms")}
    per_step["bound_ms"] = sum(r["bound"][0] for r in staged)
    per_step["bound_by"] = "bytes" if {r["bound"][1] for r in staged} == {"bytes"} else "operations"
    log(f"[3] vq_nearest_stats per train step on the device: {per_step['device_ms']:.4f} ms in "
        f"{sum(r['launches_per_call'] for r in staged):.0f} launches (the snap at the same N {per_step['snap_device_ms']:.4f}, "
        f"the statistics beyond it {per_step['beyond_snap_ms']:.4f}, a share of {per_step['beyond_snap_ms'] / per_step['device_ms']:.0%}); "
        f"bound {per_step['bound_ms']:.4f}; plan {json.dumps(vq.stats_plan(TRAIN_B * TRAIN_FRAMES, VQ_D, VQ_K)._asdict())}")
    # one rank's rows of two: a train step's statistics and a predict's snaps (rows 3 and 4)
    rank = {"stats_rows": [TRAIN_B * TRAIN_FRAMES // 8, TRAIN_B * TRAIN_FRAMES // 2], "snap_rows": [B * FRAMES // 8, B * FRAMES // 2]}
    rank["stats_device_ms"] = []
    for n in rank["stats_rows"]:
        x, e = _vq_case(gen, n)
        mask = (torch.rand(n, device="cuda", generator=gen) < 0.8).float()
        rank["stats_device_ms"].append(device_profile(lambda: vq.vq_nearest_stats(x, e, mask))["ms"])
    rank["snap_device_ms"] = []
    for n in rank["snap_rows"]:
        x, e = _vq_case(gen, n)
        rank["snap_device_ms"].append(device_profile(lambda: vq.vq_nearest(x, e))["ms"])
    rank["stats_per_step_ms"] = sum(rank["stats_device_ms"])
    rank["snap_per_predict_ms"] = 2 * sum(rank["snap_device_ms"])
    log(f"[3] on the device at one rank's rows of two: vq_nearest_stats at n={rank['stats_rows']} {rank['stats_device_ms']} ms "
        f"({rank['stats_per_step_ms']:.4f} per step), vq_nearest at n={rank['snap_rows']} {rank['snap_device_ms']} ms "
        f"({rank['snap_per_predict_ms']:.4f} per predict)")
    return {"rows": rows, "max_abs_err": worst, "rank_rows": rank, **per_step}


def _resblock_case(gen, C, k, s=None):
    s = (k * C) ** -0.5 if s is None else s
    w1 = torch.randn(k, C, C, device="cuda", generator=gen) * s
    w2 = torch.randn(k, C, C, device="cuda", generator=gen) * s
    b1 = torch.randn(C, device="cuda", generator=gen) * 0.1
    b2 = torch.randn(C, device="cuda", generator=gen) * 0.1
    return w1, b1, w2, b2


def _hold_resblock(rb, what, x, w1, b1, w2, b2, d, prepared):
    y = rb.fused_resblock_layer(x, w1, b1, w2, b2, d, prepared)
    ref = rb.fused_resblock_layer_plain(x, w1, b1, w2, b2, d)
    torch.cuda.synchronize()
    err = float((y - ref).abs().max())
    if not torch.allclose(y, ref, **RB_TOL) or err > RB_MAX_ABS:
        raise AssertionError(f"resblock {what}: max abs err {err}")
    return err


def _resblock_layers(gen, batch, frames, what, library=False, stages=STAGES, **timing):
    """Kernel 5 against its plain version at the 36 MRF layers of one decode of
    ``batch`` rows of ``frames`` frames (``stages``: the generator's (channels,
    upsample) per stage). Each row carries the kernel's and the
    plain version's time (CUDA events, ``timing`` goes to ``time_ms``), its
    bounds, and with ``library`` cuDNN's fp32 time. -> (rows, worst error)."""
    import torch.nn.functional as F

    from msmctts_tpu_torch.ops import resblock as rb

    rows, worst, T = [], 0.0, frames
    for C, up in stages:
        T *= up
        x = torch.randn(batch, T, C, device="cuda", generator=gen)
        x_ncl = x.transpose(1, 2).contiguous()
        for k in RB_KERNELS:
            w1, b1, w2, b2 = _resblock_case(gen, C, k)
            prepared = rb.prepare_taps(w1, w2)
            w1t, w2t = w1.permute(2, 1, 0).contiguous(), w2.permute(2, 1, 0).contiguous()
            for d in RB_DILATIONS:
                err = _hold_resblock(rb, f"{what} C={C} T={T} k={k} d={d}", x, w1, b1, w2, b2, d, prepared)
                worst = max(worst, err)

                def cudnn():
                    h = F.conv1d(F.leaky_relu(x_ncl, 0.1), w1t, b1, padding=(k - 1) // 2 * d, dilation=d)
                    return x_ncl + F.conv1d(F.leaky_relu(h, 0.1), w2t, b2, padding=(k - 1) // 2)

                flops = 4 * k * C * C * batch * T
                nbytes = (2 * batch * T * C + 2 * (k * C * C + C)) * 4
                plan = rb.plan_layer(C, k, d)
                row = {
                    "C": C, "T": T, "k": k, "d": d, "body": plan.body, "tile": plan.tile, "out_rows": plan.out_rows,
                    "stages": plan.stages, "shared_bytes": plan.shared_bytes, "max_abs_err": err,
                    "ms": time_ms(lambda: rb.fused_resblock_layer(x, w1, b1, w2, b2, d, prepared), **timing),
                    "plain_ms": time_ms(lambda: rb.fused_resblock_layer_plain(x, w1, b1, w2, b2, d), **timing),
                    # the kernel's operations are TF32 tensor-core products, three per fp32 product
                    "bound": bound(nbytes, 3 * flops, PEAK_TF32),
                    "bound_fp32_ms": bound(nbytes, flops)[0],  # the same products as fp32 FMA
                    "bound_tf32_ms": bound(nbytes, flops, PEAK_TF32)[0],
                    "bound_bf16_ms": bound(nbytes // 2, flops, PEAK_BF16)[0],
                }
                if library:
                    row["library_ms"] = time_ms(cudnn, **timing)
                row["tflops"] = flops / row["ms"] / 1e9
                rows.append(row)
    return rows, worst


def phase_resblock(gen):
    from msmctts_tpu_torch.ops import resblock as rb

    rows, worst = _resblock_layers(gen, B, FRAMES, "decode", library=True)
    for row in rows:
        log(f"[3] resblock {json.dumps(row)}")
    # the shapes a tensor-core tile gets wrong first: T short of a tile, one past it, not a
    # multiple of it, B = 1, a halo wider than T; large weights so that a lost tap shows
    edges = []
    for C, k, d, Bx, Tx in ((256, 11, 5, 1, 1), (256, 3, 1, 2, 63), (256, 7, 3, 1, 65), (256, 11, 1, 1, 3071),
                            (128, 11, 5, 1, 1), (128, 11, 5, 2, 25), (128, 7, 1, 1, 63), (128, 3, 3, 3, 65),
                            (64, 11, 5, 1, 1), (64, 11, 3, 1, 63), (64, 7, 5, 2, 65), (64, 3, 1, 1, 3071),
                            (32, 11, 5, 1, 1), (32, 3, 5, 1, 63), (32, 7, 1, 2, 65), (32, 11, 3, 1, 3071)):
        x = torch.randn(Bx, Tx, C, device="cuda", generator=gen)
        w1, b1, w2, b2 = _resblock_case(gen, C, k)
        err = _hold_resblock(rb, f"edge C={C} k={k} d={d} B={Bx} T={Tx}", x, w1, b1, w2, b2, d, None)
        edges.append({"C": C, "k": k, "d": d, "B": Bx, "T": Tx, "max_abs_err": err})
        worst = max(worst, err)
    log(f"[3] resblock edge shapes (taps prepared in the call): {json.dumps(edges)}")
    keys = ("ms", "plain_ms", "library_ms", "bound_fp32_ms", "bound_tf32_ms", "bound_bf16_ms")
    total = {key: sum(r[key] for r in rows) for key in keys}
    total["bound_ms"] = sum(r["bound"][0] for r in rows)
    per_width = {
        C: {"ms": sum(r["ms"] for r in rows if r["C"] == C), "library_ms": sum(r["library_ms"] for r in rows if r["C"] == C),
            "bound_ms": sum(r["bound"][0] for r in rows if r["C"] == C),
            "bound_fp32_ms": sum(r["bound_fp32_ms"] for r in rows if r["C"] == C)}
        for C, _ in STAGES
    }
    log(f"[3] resblock per width, 9 layers each (kernel / cuDNN fp32 / 3xTF32 bound / fp32 FMA bound): {json.dumps(per_width)}")
    log(f"[3] resblock, all 36 layers of one decode (B={B}, {FRAMES} frames): {json.dumps(total)}")
    return {"rows": rows, "edges": edges, "per_width": per_width, "max_abs_err": worst, **total}


def _reset_counts():
    from msmctts_tpu_torch.ops import resblock, vq

    vq.KERNEL.launches = 0
    vq.STATS_KERNEL.launches = 0
    resblock.KERNEL.launches = 0


def _counts():
    from msmctts_tpu_torch.ops import resblock, vq

    return {"vq_nearest": vq.KERNEL.launches, "vq_nearest_stats": vq.STATS_KERNEL.launches,
            "fused_resblock_layer": resblock.KERNEL.launches}


def _check_wavs(wavs, lengths, ratio, what):
    for w, n in zip(wavs, lengths):
        if w.shape != (int(n) * ratio,):
            raise AssertionError(f"{what}: wav of {w.shape} samples for {n} frames x {ratio}")
        if not np.isfinite(w).all():
            raise AssertionError(f"{what}: non-finite samples")
        if np.abs(w).max() < 1e-3:
            raise AssertionError(f"{what}: silent output")


def phase_analysis_synthesis():
    from msmctts_tpu_torch.config import Config
    from msmctts_tpu_torch.data.datasets import FRAME_BUCKETS, bucket_length
    from msmctts_tpu_torch.tasks import build_task
    from msmctts_tpu_torch.utils.checkpoint import load_checkpoint

    ckpt = load_checkpoint(FIXTURE)
    cfg = Config(ckpt["config"])
    task = build_task(cfg, device="cuda")
    task.load_variables(ckpt["state"])
    ratio = task.networks["autoencoder"].frameshift_ratio
    rng = np.random.default_rng(0)

    # small input: the card's path against the same model on the CPU
    cpu = build_task(cfg, device="cpu")
    cpu.load_variables(ckpt["state"])
    small = {"mel": rng.normal(size=(1, 64, 80)).astype(np.float32) * 0.5, "mel_length": np.array([64])}
    got, want = task.analysis_synthesis(small), cpu.analysis_synthesis(small)
    err = float(np.abs(got["wav"][0] - want["wav"][0]).max())
    with torch.inference_mode():
        gi = task.networks["autoencoder"].analysis(torch.as_tensor(small["mel"], device="cuda"), torch.tensor([64], device="cuda"))
        ci = cpu.networks["autoencoder"].analysis(torch.as_tensor(small["mel"]), torch.tensor([64]))
    idx_equal = all(torch.equal(a.cpu(), b) for a, b in zip(gi["quantizer_indices"], ci["quantizer_indices"]))
    log(f"[4] analysis-synthesis T=64, card vs CPU: wav max abs err {err:.3g}, indices equal {idx_equal}")
    if err > AS_TOL or not idx_equal:
        raise AssertionError(f"analysis-synthesis disagrees with the CPU: err {err}, indices equal {idx_equal}")
    del cpu

    lengths = np.array([256, 448])
    T = bucket_length(int(lengths.max()), FRAME_BUCKETS)
    mel = rng.normal(size=(2, T, 80)).astype(np.float32) * 0.5
    mel *= (np.arange(T)[None, :] < lengths[:, None])[..., None]
    batch = {"mel": mel, "mel_length": lengths}
    task.analysis_synthesis(batch)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    out = task.analysis_synthesis(batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = _counts()
    _check_wavs(out["wav"], lengths, ratio, "analysis-synthesis")
    log(f"[4] analysis-synthesis B=2 frames {lengths.tolist()} (bucket {T}): {ms:.2f} ms, launches {counts}")
    if counts != {"vq_nearest": 2, "vq_nearest_stats": 0, "fused_resblock_layer": 36}:
        raise AssertionError(f"analysis-synthesis launches {counts}, expected 2 VQ and 36 resblock")
    return {"cpu_wav_err": err, "ms": ms, "launches": counts}


def _text(rng, n_phones, n_symbols, Lt):
    text = np.zeros((len(n_phones), Lt, len(n_symbols)), np.int64)
    for i, n in enumerate(n_phones):
        for j, s in enumerate(n_symbols):
            text[i, :n, j] = rng.integers(1, s, size=n)  # 0 is padding
    return text


def phase_text_to_wav(card, seed=1234):
    from msmctts_tpu_torch.config import Config
    from msmctts_tpu_torch.data.datasets import TEXT_BUCKETS, bucket_length
    from msmctts_tpu_torch.tasks import build_task
    from msmctts_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from msmctts_tpu_torch.weights import init_random, multi_stage_predictor_to_jax, state_dict_numpy

    cfg = Config(AM_YAML)
    cfg.task["autoencoder"]["_checkpoint"] = FIXTURE
    cfg.task["autoencoder"].pop("_config", None)  # use the fixture's embedded config
    task = build_task(cfg, device="cuda")
    predictor = task.networks["predictor"]
    init_random(predictor, seed)
    predictor.bias_durations(4.2)  # ~3.6 frames per phone after clamping and rounding
    n_params = sum(p.numel() for p in predictor.parameters())
    os.makedirs(SMOKE_DIR, exist_ok=True)
    am_path = os.path.join(SMOKE_DIR, "am_seeded.ckpt")
    state = {"params": {"predictor": multi_stage_predictor_to_jax(state_dict_numpy(predictor))}}
    save_checkpoint(am_path, state, 0, cfg.to_dict())
    log(f"[5] seeded acoustic model: {n_params / 1e6:.1f}M parameters -> {am_path}")

    rng = np.random.default_rng(seed)
    n_symbols = list(cfg.task["predictor"]["n_symbols"])
    one = _text(rng, [17], n_symbols, 17)[0]
    tokens = " ".join("_".join(str(v) for v in row) for row in one)
    wav_path = os.path.join(SMOKE_DIR, "synthesize.wav")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()  # the CLI's process starts while the card vs CPU check runs here
    synth = subprocess.Popen(
        [sys.executable, "-m", "msmctts_tpu_torch.synthesize", "-m", am_path, "--text", tokens, "-o", wav_path],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )

    task.load_variables(load_checkpoint(am_path)["state"])  # the weights as written
    task.pre_infer()
    ratio = task.networks["autoencoder"].frameshift_ratio

    # small request against the same model on the CPU
    cpu = build_task(cfg, device="cpu")
    cpu.load_variables(load_checkpoint(am_path)["state"])
    cpu.pre_infer()
    small = {"text": one[None], "text_length": np.array([len(one)])}
    got, want = task.predict(small), cpu.predict(small)
    err = float(np.abs(got["wav"][0] - want["wav"][0]).max())
    same = np.array_equal(got["duration"], want["duration"]) and np.array_equal(got["embedding"][0], want["embedding"][0])
    log(f"[5] predict, 17 phones, card vs CPU: durations+codewords equal {same}, wav max abs err {err:.3g}")
    if not same or err > AS_TOL:
        raise AssertionError(f"predict disagrees with the CPU: equal {same}, err {err}")
    del cpu
    stdout, stderr = synth.communicate(timeout=600)
    if synth.returncode != 0 or not os.path.exists(wav_path):
        raise AssertionError(f"synthesize failed ({synth.returncode}):\n{stdout}\n{stderr}")
    log(f"[5] synthesize subprocess ({time.perf_counter() - t0:.1f}s, the CPU check meanwhile): "
        f"{stdout.strip().splitlines()[-1]}")

    n_phones = [24, 57, 96, 128]
    Lt = bucket_length(max(n_phones), TEXT_BUCKETS)
    batch = {"text": _text(rng, n_phones, n_symbols, Lt), "text_length": np.array(n_phones)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    task.predict(batch)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3

    _reset_counts()
    out = task.predict(batch)
    torch.cuda.synchronize()
    counts = _counts()
    total = out["mel_length"]
    frame_bucket = task._predict_phase1(batch)["max_frames"]
    _check_wavs(out["wav"], total, ratio, "predict")
    log(f"[5] predict B={len(n_phones)} phones {n_phones} (text bucket {Lt}, frame bucket {frame_bucket}): "
        f"frames {total.tolist()}, launches {counts}")
    if counts != {"vq_nearest": 4, "vq_nearest_stats": 0, "fused_resblock_layer": 36}:
        raise AssertionError(f"predict launches {counts}, expected 4 VQ and 36 resblock")

    warm = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        task.predict(batch)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
    audio_s = float(total.sum()) * ratio / task.samplerate
    warm_ms = statistics.median(warm)
    log(f"[5] predict per batch on {card}: first {first_ms:.1f} ms, warm median {warm_ms:.1f} ms "
        f"(runs {[round(w, 1) for w in warm]}), {audio_s:.2f} s of audio, {audio_s / warm_ms * 1e3:.1f}x real time")
    result = {
        "launches": counts, "frames": total.tolist(), "text_bucket": Lt, "frame_bucket": frame_bucket,
        "first_ms": first_ms, "warm_ms": warm_ms, "warm_runs_ms": warm, "audio_s": audio_s,
        "cpu_wav_err": err, "am_params": n_params,
    }
    reference = {"am_path": am_path, "batch": batch, "out": out, "n_symbols": n_symbols}
    return result, lambda: task.predict(batch), reference


def _train_batch(rng, lengths, T, n_mel=80, frameshift=300):
    """Seeded synthetic mel/wav, padded as ``MelDataset`` pads (mel -4, wav 0)."""
    lengths = np.asarray(lengths, np.int32)
    valid = np.arange(T)[None, :] < lengths[:, None]
    mel = np.where(valid[..., None], rng.normal(size=(len(lengths), T, n_mel)) * 0.5, -4.0).astype(np.float32)
    wav = (rng.normal(size=(len(lengths), T * frameshift)) * 0.1 * np.repeat(valid, frameshift, axis=1)).astype(np.float32)
    return {"mel": mel, "mel_length": lengths, "wav": wav}


def _build_trainer(device, warmup_steps, dropout=None, seed=1234, group=None, precision=None, mesh_node=None):
    """The CSMSC autoencoder recipe through the normal construction, with
    the trained autoencoder of the fixture and a seeded discriminator;
    ``mesh_node`` ({data, model}) for tensor parallelism over ``group``."""
    from msmctts_tpu_torch.config import component_kwargs
    from msmctts_tpu_torch.registry import get_trainer
    from msmctts_tpu_torch.tasks import build_task
    from msmctts_tpu_torch.utils.checkpoint import load_checkpoint

    cfg = _recipe_config(AE_YAML, os.path.join(SMOKE_DIR, "ckpt_ae"), warmup_steps, dropout, seed, precision)
    if mesh_node is not None:
        cfg["mesh"] = dict(mesh_node)
    task = build_task(cfg, device=device, mode="train")
    trainer = get_trainer(cfg.trainer["_name"])(cfg, task, group=group, **component_kwargs(cfg.trainer))
    trainer.init_state()
    trainer.load_state_tree(load_checkpoint(FIXTURE)["state"])  # autoencoder only: the fixture has no discriminator
    return trainer


def _moved(module, before):
    return sum(int(not torch.equal(p, b)) for p, b in zip(module.parameters(), before))


def _training_batch():
    """The global batch of phases 6 and 10 (numpy, seeded)."""
    rng = np.random.default_rng(1234)
    lengths = rng.integers(200, TRAIN_FRAMES + 1, size=TRAIN_B)
    lengths[0] = TRAIN_FRAMES
    return _train_batch(rng, lengths, TRAIN_FRAMES), lengths, rng


def _codebook_state(ae):
    return [tuple(t.detach().cpu().clone() for t in (q.embed, q.cluster_size, q.embed_avg)) for q in ae.quantizer.quantizer]


def phase_training(card, with_profile=False):
    from msmctts_tpu_torch.config import Config
    from msmctts_tpu_torch.data.loader import to_device
    from msmctts_tpu_torch.tasks import build_task
    from msmctts_tpu_torch.training.base_trainer import metrics_to_host
    from msmctts_tpu_torch.weights import train_state_to_jax

    trainer = _build_trainer("cuda", warmup_steps=2)
    ae, disc = trainer.ae, trainer.disc
    n_ae, n_d = (sum(p.numel() for p in m.parameters()) for m in (ae, disc))
    batch_np, lengths, rng = _training_batch()
    batch = to_device(batch_np, "cuda")
    log(f"[6] CSMSC autoencoder {n_ae / 1e6:.1f}M parameters, discriminator {n_d / 1e6:.1f}M; batch {TRAIN_B}, "
        f"{TRAIN_FRAMES} frames, lengths {lengths.min()}-{lengths.max()}, windows of {trainer.sample_lengths} samples")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps, total_counts = [], {}
    codebook0 = [(q.embed.clone(), q.cluster_size.clone()) for q in ae.quantizer.quantizer]
    indices, codebooks = [], []
    hooks = [q.register_forward_hook(lambda m, a, o: indices.append(o[2].cpu())) for q in ae.quantizer.quantizer]
    for it in range(1, 5):
        phase = "warmup" if it <= trainer.warmup_steps else "gan"
        ae_before = [p.detach().clone() for p in ae.parameters()]
        d_before = [p.detach().clone() for p in disc.parameters()]
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch, it)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = _counts()
        host = metrics_to_host(metrics)
        bad = [k for k, v in host.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"train step {it}: non-finite metrics {bad}")
        if counts != {"vq_nearest": 0, "vq_nearest_stats": 2, "fused_resblock_layer": 0}:
            raise AssertionError(f"train step {it}: launches {counts}, expected 2 vq_nearest_stats only")
        ae_moved, d_moved = _moved(ae, ae_before), _moved(disc, d_before)
        if ae_moved == 0 or (phase == "warmup") != (d_moved == 0):
            raise AssertionError(f"train step {it} ({phase}): {ae_moved} autoencoder and {d_moved} discriminator tensors moved")
        for k, v in counts.items():
            total_counts[k] = total_counts.get(k, 0) + v
        steps.append({"iteration": it, "phase": phase, "ms": ms, "metrics": host,
                      "ae_tensors_moved": ae_moved, "d_tensors_moved": d_moved})
        shown = {k: round(host[k], 4) for k in ("g_loss", "vq_loss", "frame_loss", "d_loss", "stft_loss", "fm_loss") if k in host}
        log(f"[6] step {it} ({phase}): {ms:.1f} ms, launches {counts}, moved ae {ae_moved} d {d_moved}, {shown}")
        codebooks.append(_codebook_state(ae))
    for h in hooks:
        h.remove()
    # what the two-rank run of phase 10 is held against: two stage passes per step
    reference = {"metrics": [st["metrics"] for st in steps], "indices": indices, "codebooks": codebooks}
    for (e0, c0), q in zip(codebook0, ae.quantizer.quantizer):
        if torch.equal(e0, q.embed) or torch.equal(c0, q.cluster_size):
            raise AssertionError("the codebook EMA did not move")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    # warm per-step times: the same two graphs a few more times
    def timed(it):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch, it)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    warm_warmup = [timed(1) for _ in range(5)]
    warm_gan = [timed(5 + i) for i in range(5)]
    result = {
        "steps": steps, "launches": total_counts, "peak_memory_gib": peak_gb,
        "warmup_first_ms": steps[0]["ms"], "warmup_warm_ms": statistics.median(warm_warmup), "warmup_runs_ms": warm_warmup,
        "gan_first_ms": steps[2]["ms"], "gan_warm_ms": statistics.median(warm_gan), "gan_runs_ms": warm_gan,
        "ae_params": n_ae, "d_params": n_d,
    }
    log(f"[6] per step on {card}: warmup first {result['warmup_first_ms']:.1f} ms, warm median {result['warmup_warm_ms']:.1f} ms; "
        f"GAN first {result['gan_first_ms']:.1f} ms, warm median {result['gan_warm_ms']:.1f} ms "
        f"(runs {[round(w, 1) for w in warm_gan]}); peak memory {peak_gb:.2f} GiB")
    # what drawing the dropout masks of a global batch of WORLD times its rows costs a
    # rank: this process on 1 / WORLD of the batch, drawing for itself and for WORLD
    # ranks in turns (no collective either way)
    from msmctts_tpu_torch.ops.dropout import bind_generator

    def timed_on(rows, it):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(rows, it)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    rows = {k: v[: TRAIN_B // WORLD] for k, v in batch.items()}
    draws = {}
    for turn in range(4):
        world = WORLD if turn % 2 else 1
        for module in (ae, disc):
            bind_generator(module, trainer.generator, shard=(0, world))
        times = draws.setdefault(world, {"warmup": [], "gan": []})
        timed_on(rows, 1), timed_on(rows, 30)  # settle after the switch
        times["warmup"] += [timed_on(rows, 1) for _ in range(4)]
        times["gan"] += [timed_on(rows, 30 + i) for i in range(4)]
    for module in (ae, disc):
        bind_generator(module, trainer.generator, shard=(0, 1))
    result["dropout_draws"] = {
        f"{phase}_ms_drawing_for_{w}": statistics.median(draws[w][phase]) for w in draws for phase in ("warmup", "gan")
    }
    log(f"[6] a step on {TRAIN_B // WORLD} rows, dropout masks drawn for 1 and for {WORLD} ranks' rows "
        f"(median of 8, in turns): {json.dumps({k: round(v, 1) for k, v in result['dropout_draws'].items()})}")
    if with_profile:
        result["profile"] = profile_call(lambda: trainer.train_step(batch, 20), "[6]", "GAN step")

    # back to eval: re-folded weights, the fused resblock kernel, against the CPU
    ae.eval()
    cpu = build_task(Config(trainer.config.to_dict()), device="cpu")
    cpu.load_variables(train_state_to_jax(ae, disc))
    in_dim = trainer.config.task["autoencoder"]["in_dim"]
    small = {"mel": rng.normal(size=(1, 64, in_dim)).astype(np.float32) * 0.5, "mel_length": np.array([64])}
    _reset_counts()
    got = trainer.task.analysis_synthesis(small)
    counts = _counts()
    want = cpu.analysis_synthesis(small)
    err = float(np.abs(got["wav"][0] - want["wav"][0]).max())
    log(f"[6] trained module in eval mode, analysis-synthesis T=64, card vs CPU: wav max abs err {err:.3g}, launches {counts}")
    if counts != {"vq_nearest": 2, "vq_nearest_stats": 0, "fused_resblock_layer": 36}:
        raise AssertionError(f"eval after training: launches {counts}, expected 2 VQ and 36 resblock")
    if err > AS_TOL:
        raise AssertionError(f"eval after training disagrees with the CPU by {err} (stale folded weights?)")
    result["eval_cpu_wav_err"] = err
    return result, reference


def phase_step_card_vs_cpu():
    """One warmup and one GAN step from identical state and batch on the
    card and on the CPU: full width, 2 short utterances, dropout 0, the
    same window starts."""
    from msmctts_tpu_torch.data.loader import to_device
    from msmctts_tpu_torch.training.base_trainer import metrics_to_host

    rng = np.random.default_rng(7)
    batch = _train_batch(rng, [64, 48], 64)
    starts = np.array([11, 3])
    out = {}
    for device in ("cuda", "cpu"):
        trainer = _build_trainer(device, warmup_steps=1, dropout=0.0)
        indices = []
        hooks = [q.register_forward_hook(lambda m, a, o: indices.append(o[2].cpu())) for q in trainer.ae.quantizer.quantizer]
        dev_batch = to_device(batch, device)
        m1 = metrics_to_host(trainer.train_step(dev_batch, 1))
        m2 = metrics_to_host(trainer.train_step(dev_batch, 2, starts=torch.as_tensor(starts, device=device)))
        for h in hooks:
            h.remove()
        out[device] = {"warmup": m1, "gan": m2, "indices": indices,
                       "codebook": [(q.embed.cpu(), q.cluster_size.cpu(), q.embed_avg.cpu()) for q in trainer.ae.quantizer.quantizer]}
        del trainer
    worst = {"loss_rel": 0.0, "codebook_abs": 0.0}
    for phase in ("warmup", "gan"):
        for k, want in out["cpu"][phase].items():
            got = out["cuda"][phase][k]
            rel = abs(got - want) / max(abs(want), 1e-3)
            worst["loss_rel"] = max(worst["loss_rel"], rel)
            if rel > STEP_TOL["loss_rtol"]:
                raise AssertionError(f"{phase} step, {k}: card {got} vs CPU {want}")
    same = all(torch.equal(a, b) for a, b in zip(out["cuda"]["indices"], out["cpu"]["indices"]))
    for a, b in zip(out["cuda"]["codebook"], out["cpu"]["codebook"]):
        for x, y in zip(a, b):
            worst["codebook_abs"] = max(worst["codebook_abs"], float((x - y).abs().max()))
    log(f"[7] one warmup + one GAN step, card vs CPU (B=2, 64 frames): indices equal {same} "
        f"({len(out['cuda']['indices'])} stage passes), worst loss rel diff {worst['loss_rel']:.3g}, "
        f"worst codebook abs diff {worst['codebook_abs']:.3g}")
    if not same or worst["codebook_abs"] > STEP_TOL["codebook_atol"]:
        raise AssertionError(f"train step disagrees with the CPU: indices equal {same}, {worst}")
    return {**worst, "indices_equal": same, "card": {k: out["cuda"][k] for k in ("warmup", "gan")},
            "cpu": {k: out["cpu"][k] for k in ("warmup", "gan")}}


# ------------------------------------------------- data-parallel phases
# What a rank runs is a module-level function: the ranks are spawned
# processes that import this file to find it.


def _run_ranks(fn, world, backend, *args):
    from msmctts_tpu_torch.parallel.launch import run_ranks

    torch.cuda.empty_cache()  # the ranks share this process's card
    return run_ranks(fn, world, backend, ["cuda:0"] * world, *args, timeout_s=RANKS_TIMEOUT_S)


def _host_ms(fn, runs=20, warmup=3):
    """Per-call host-clock time of ``fn()``, each window ending in a device
    synchronize (a gloo collective runs on the host: CUDA events miss it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / runs


def _stats_bound(N, valid):
    nbytes = (N * VQ_H * VQ_D * 2 + VQ_H * VQ_D * VQ_K + N + N * VQ_H + VQ_H * VQ_K + VQ_H * VQ_D * VQ_K) * 4
    flops = 2 * N * VQ_H * VQ_D * VQ_K + 3 * N * VQ_H * VQ_K + valid * VQ_H * (2 * VQ_D + 1)
    return bound(nbytes, flops)


def _snap_bound(N):
    nbytes = (N * VQ_H * VQ_D * 2 + VQ_H * VQ_D * VQ_K + N * VQ_H) * 4
    return bound(nbytes, 2 * N * VQ_H * VQ_D * VQ_K + 3 * N * VQ_H * VQ_K)


def rank_sharded_kernels(group, device):
    """Both sharded functions on this rank's rows of seeded global inputs
    (every rank draws the same), against their plain versions and against
    the one-rank kernels on all rows; then times."""
    from msmctts_tpu_torch.ops import vq
    from msmctts_tpu_torch.parallel import mesh
    from msmctts_tpu_torch.utils.device import exact_fp32

    exact_fp32()
    gen = torch.Generator(device="cuda").manual_seed(11)
    rank, world = group.rank, group.world
    n0, n1 = TRAIN_B * TRAIN_FRAMES // 4, TRAIN_B * TRAIN_FRAMES
    even = lambda N: [N * r // world for r in range(world + 1)]
    cases = [("stage0", n0, even(n0), False), ("stage1", n1, even(n1), False),
             ("ragged", n1 - 1, [0, n1 // 2, n1 - 1], False), ("rank1-masked", n1, even(n1), True),
             ("rank1-empty", n0, [0, n0, n0], False)]
    rows = []
    for label, N, splits, mask_rank1 in cases:
        x, e = _vq_case(gen, N)
        mask = (torch.rand(N, device="cuda", generator=gen) < 0.8).float()
        if mask_rank1:
            mask[splits[1] : splits[2]] = 0.0
        lo, hi = splits[rank], splits[rank + 1]
        xl, ml = x[lo:hi], mask[lo:hi].contiguous()
        mesh.reset_collective_counts()
        _reset_counts()
        idx, quant, counts, sums = vq.vq_nearest_stats_sharded(xl, e, ml, group)
        collectives, launches = mesh.collective_counts(), _counts()
        again = vq.vq_nearest_stats_sharded(xl, e, ml, group)
        p_idx, p_quant, p_counts, p_sums = vq.vq_nearest_stats_sharded_plain(xl, e, ml, group)
        o_idx, o_quant, o_counts, o_sums = vq.vq_nearest_stats(x, e, mask)  # one rank, all rows
        torch.cuda.synchronize()
        what = f"vq_nearest_stats_sharded {label} rank {rank}"
        if collectives["all_reduce"] != {"calls": 1, "bytes": (VQ_H * VQ_K + VQ_H * VQ_D * VQ_K) * 4}:
            raise AssertionError(f"{what}: collectives {collectives}, expected one all-reduce of the flat buffer")
        if launches["vq_nearest_stats"] != (1 if hi > lo else 0) or launches["vq_nearest"]:
            raise AssertionError(f"{what}: {launches} launches for {hi - lo} rows")
        if not all(torch.equal(a, b) for a, b in zip((idx, quant, counts, sums), again)):
            raise AssertionError(f"{what}: two runs on the same input differ")
        if not (torch.equal(idx, p_idx) and torch.equal(quant, p_quant) and torch.equal(counts, p_counts)):
            raise AssertionError(f"{what}: idx/quant/counts differ from the plain version")
        if not (torch.equal(idx, o_idx[lo:hi]) and torch.equal(quant, o_quant[lo:hi]) and torch.equal(counts, o_counts)):
            raise AssertionError(f"{what}: idx/quant/counts differ from the one-rank kernel")
        if float(counts.sum()) != float(mask.sum()) * VQ_H:
            raise AssertionError(f"{what}: global counts do not sum to the valid rows")
        err_plain, err_one = float((sums - p_sums).abs().max()), float((sums - o_sums).abs().max())
        if not (torch.allclose(sums, p_sums, **VQS_TOL) and torch.allclose(sums, o_sums, **VQS_TOL)):
            raise AssertionError(f"{what}: sums differ by {err_plain} (plain) / {err_one} (one rank)")

        mesh.reset_collective_counts()
        _reset_counts()
        s_idx, s_quant = vq.vq_nearest_sharded(xl, e)
        snap_launches = _counts()["vq_nearest"]
        sp_idx, sp_quant = vq.vq_nearest_sharded_plain(xl, e)
        g_idx, g_quant = vq.vq_nearest(x, e)
        torch.cuda.synchronize()
        if any(v["calls"] for v in mesh.collective_counts().values()):
            raise AssertionError(f"vq_nearest_sharded {label}: it communicated: {mesh.collective_counts()}")
        if snap_launches != (1 if hi > lo else 0):
            raise AssertionError(f"vq_nearest_sharded {label} rank {rank}: {snap_launches} launches for {hi - lo} rows")
        if not (torch.equal(s_idx, g_idx[lo:hi]) and torch.equal(s_quant, g_quant[lo:hi]) and torch.equal(s_idx, idx)):
            raise AssertionError(f"vq_nearest_sharded {label} rank {rank}: differs from the one-rank snap")
        snap_err, snap_mismatches = _hold_snap(f"vq_nearest_sharded {label} rank {rank}", xl, e, s_idx, s_quant, sp_idx, sp_quant)
        rows.append({"label": label, "N": N, "rows": hi - lo, "valid": int(ml.sum()), "walkers": vq.stats_plan(hi - lo, VQ_D, VQ_K).walkers,
                     "sums_err_vs_plain": err_plain, "sums_err_vs_one_rank": err_one,
                     "snap_err_vs_plain": snap_err, "snap_mismatches": snap_mismatches,
                     "counts": counts.cpu(), "sums": sums.cpu()})

    # times at the per-rank rows of one train step (global batch 16) and of one
    # predict (global batch 4, frame bucket 512); one rank at a time has the card
    timing = {}
    flat = torch.zeros(VQ_H * VQ_K + VQ_H * VQ_D * VQ_K, device="cuda")
    stats_in = [(N // world,) + _vq_case(gen, N // world) for N in (n0, n1)]
    stats_in = [(N, x, e, (torch.rand(N, device="cuda", generator=gen) < 0.8).float()) for N, x, e in stats_in]
    snap_in = [(N // world,) + _vq_case(gen, N // world) for N in (B * FRAMES // 4, B * FRAMES)]
    snap_rows = []
    for n, x, e in snap_in:  # the rows that predict over these ranks gives the snap
        mesh.reset_collective_counts()
        _reset_counts()
        s_idx, s_quant = vq.vq_nearest_sharded(x, e)
        launches = _counts()
        sp_idx, sp_quant = vq.vq_nearest_sharded_plain(x, e)
        torch.cuda.synchronize()
        if launches["vq_nearest"] != 1 or any(v["calls"] for v in mesh.collective_counts().values()):
            raise AssertionError(f"vq_nearest_sharded n={n} rank {rank}: launches {launches}, collectives {mesh.collective_counts()}")
        err, mismatches = _hold_snap(f"vq_nearest_sharded n={n} rank {rank}", x, e, s_idx, s_quant, sp_idx, sp_quant)
        snap_rows.append({"rows": n, "snap_err_vs_plain": err, "snap_mismatches": mismatches})
    for turn in range(world):
        if turn == rank:
            timing["stats_kernel_ms"] = [time_ms(lambda: vq.vq_nearest_stats(x, e, m), runs=50) for _, x, e, m in stats_in]
            timing["stats_plain_ms"] = [time_ms(lambda: vq.vq_nearest_stats_plain(x, e, m), runs=50) for _, x, e, m in stats_in]
            timing["snap_kernel_ms"] = [time_ms(lambda: vq.vq_nearest_sharded(x, e), runs=50) for _, x, e in snap_in]
            timing["snap_plain_ms"] = [time_ms(lambda: vq.vq_nearest_sharded_plain(x, e), runs=50) for _, x, e in snap_in]
        mesh.barrier(group)
    timing["all_reduce_ms"] = _host_ms(lambda: mesh.all_reduce_sum(flat, group))
    mesh.barrier(group)
    timing["stats_sharded_ms"] = [_host_ms(lambda: vq.vq_nearest_stats_sharded(x, e, m, group)) for _, x, e, m in stats_in]
    timing["stats_sharded_plain_ms"] = [_host_ms(lambda: vq.vq_nearest_stats_sharded_plain(x, e, m, group)) for _, x, e, m in stats_in]
    timing["stats_bound"] = [_stats_bound(N, int(m.sum())) for N, _, _, m in stats_in]
    timing["snap_bound"] = [_snap_bound(N) for N, _, _ in snap_in]
    timing["stats_rows"] = [N for N, *_ in stats_in]
    timing["snap_rows"] = [N for N, *_ in snap_in]
    timing["all_reduce_bytes"] = flat.numel() * 4
    return {"rows": rows, "snap_rows": snap_rows, "timing": timing}


def rank_group_phases(group, device, batch_np, reference_indices, am_path, batch, engine_texts):
    """Phases 8, 10 and 11 on this rank, one after the other in one spawn."""
    out = {"sharded": rank_sharded_kernels(group, device)}
    torch.cuda.empty_cache()
    out["train"] = rank_train(group, device, batch_np, reference_indices)
    torch.cuda.empty_cache()
    out["predict"] = rank_predict(group, device, am_path, batch, engine_texts)
    return out


def _group_texts(n_symbols):
    """Phase 11's requests of the engine over the group."""
    rng = np.random.default_rng(11)
    return [_phone_string(_text(rng, [n], n_symbols, n)[0]) for n in (24, 57, 40)][:GROUP_TEXTS]


def phase_two_ranks(backend, batch_np, train_ref, tts_ref):
    """The ranks of phases 8, 10 and 11: one spawn of ``WORLD`` processes
    sharing the card. -> {phase: [result per rank]}."""
    res = _run_ranks(rank_group_phases, WORLD, backend, batch_np, train_ref["indices"], tts_ref["am_path"],
                     tts_ref["batch"], _group_texts(tts_ref["n_symbols"]))
    return {k: [r[k] for r in res] for k in ("sharded", "train", "predict")}


def phase_sharded_kernels(res, backend, card):
    worst_plain = worst_one = worst_snap = 0.0
    snap_mismatches = 0
    for case in zip(*(r["snap_rows"] for r in res)):
        worst_snap = max(worst_snap, *(c["snap_err_vs_plain"] for c in case))
        snap_mismatches += sum(c["snap_mismatches"] for c in case)
        log(f"[8] vq_nearest_sharded at predict's n={case[0]['rows']} rows per rank vs its plain version: codewords max abs err "
            f"{max(c['snap_err_vs_plain'] for c in case)}, indices differing (equal distances) {[c['snap_mismatches'] for c in case]}; "
            "one launch, 0 collectives")
    for case in zip(*(r["rows"] for r in res)):
        for other in case[1:]:  # the global statistics: bit-equal on every rank
            if not (torch.equal(other["counts"], case[0]["counts"]) and torch.equal(other["sums"], case[0]["sums"])):
                raise AssertionError(f"sharded statistics {case[0]['label']}: ranks disagree")
        worst_plain = max(worst_plain, *(c["sums_err_vs_plain"] for c in case))
        worst_one = max(worst_one, *(c["sums_err_vs_one_rank"] for c in case))
        worst_snap = max(worst_snap, *(c["snap_err_vs_plain"] for c in case))
        snap_mismatches += sum(c["snap_mismatches"] for c in case)
        log(f"[8] {case[0]['label']} N={case[0]['N']}: rows per rank {[c['rows'] for c in case]}, valid {[c['valid'] for c in case]}, "
            f"walkers {[c['walkers'] for c in case]}; idx/quant/counts exact, ranks bit-equal, "
            f"sums err vs plain {max(c['sums_err_vs_plain'] for c in case):.3g}, vs one rank {max(c['sums_err_vs_one_rank'] for c in case):.3g}; "
            f"snap equal to the one-rank snap, vs plain max abs err {max(c['snap_err_vs_plain'] for c in case)}, 0 collectives")
    t = [r["timing"] for r in res]
    link_ms = 2 * (WORLD - 1) / WORLD * t[0]["all_reduce_bytes"] / NVLINK_BYTES * 1e3
    out = {
        "backend": backend, "world": WORLD, "max_err_vs_plain": worst_plain, "max_err_vs_one_rank": worst_one,
        "snap_err_vs_plain": worst_snap, "snap_index_mismatches": snap_mismatches,
        "stats_rows": t[0]["stats_rows"], "snap_rows": t[0]["snap_rows"],
        # per rank, summed over the calls of one step / one predict; the slower rank
        "stats_kernel_ms": max(sum(r["stats_kernel_ms"]) for r in t), "stats_plain_ms": max(sum(r["stats_plain_ms"]) for r in t),
        "stats_sharded_ms": max(sum(r["stats_sharded_ms"]) for r in t),
        "stats_sharded_plain_ms": max(sum(r["stats_sharded_plain_ms"]) for r in t),
        "all_reduce_ms": max(r["all_reduce_ms"] for r in t), "all_reduce_bytes": t[0]["all_reduce_bytes"],
        "all_reduce_link_bound_ms": link_ms,
        "stats_kernel_bound_ms": sum(b[0] for b in t[0]["stats_bound"]),
        "stats_bound_by": "bytes" if {b[1] for b in t[0]["stats_bound"]} == {"bytes"} else "operations",
        "snap_kernel_ms": max(2 * sum(r["snap_kernel_ms"]) for r in t), "snap_plain_ms": max(2 * sum(r["snap_plain_ms"]) for r in t),
        "snap_bound_ms": 2 * sum(b[0] for b in t[0]["snap_bound"]),
        "snap_bound_by": "bytes" if {b[1] for b in t[0]["snap_bound"]} == {"bytes"} else "operations",
        "per_rank": t,
    }
    log(f"[8] on {card}, {WORLD} ranks sharing the card, backend {backend}: vq_stats kernel at {out['stats_rows']} rows "
        f"{out['stats_kernel_ms']:.3f} ms per step per rank (plain {out['stats_plain_ms']:.3f}, bound {out['stats_kernel_bound_ms']:.4f}); "
        f"all-reduce of {out['all_reduce_bytes']} bytes {out['all_reduce_ms']:.3f} ms per call "
        f"(bound over one NVLink direction {link_ms:.5f} ms, not measured: one card); the sharded function, both stages, "
        f"{out['stats_sharded_ms']:.3f} ms (plain {out['stats_sharded_plain_ms']:.3f}); vq_nearest_sharded at {out['snap_rows']} rows "
        f"{out['snap_kernel_ms']:.3f} ms per predict per rank (plain {out['snap_plain_ms']:.3f}, bound {out['snap_bound_ms']:.4f})")
    return out


def rank_nccl(group, device, batch_np):
    """World size 1 over NCCL: the branch a multi-GPU host takes."""
    import torch.distributed as dist

    from msmctts_tpu_torch.data.loader import to_device
    from msmctts_tpu_torch.ops import vq
    from msmctts_tpu_torch.parallel import mesh
    from msmctts_tpu_torch.training.base_trainer import metrics_to_host

    t = torch.arange(8, device=device, dtype=torch.float32)
    dist.all_reduce(t, group=group.pg)  # a raw collective: the wrappers skip one in a group of one
    flag = torch.ones(1)
    dist.all_reduce(flag, group=group.control)
    torch.cuda.synchronize()
    if t.tolist() != list(range(8)) or flag.item() != 1.0:
        raise AssertionError(f"all-reduce in a group of one changed its input: {t.tolist()}, {flag.item()}")
    gen = torch.Generator(device="cuda").manual_seed(3)
    x, e = _vq_case(gen, 1600)
    mask = (torch.rand(1600, device="cuda", generator=gen) < 0.8).float()
    mesh.reset_collective_counts()
    same = all(torch.equal(a, b) for a, b in zip(vq.vq_nearest_stats_sharded(x, e, mask, group), vq.vq_nearest_stats(x, e, mask)))
    same = same and all(torch.equal(a, b) for a, b in zip(vq.vq_nearest_sharded(x, e), vq.vq_nearest(x, e)))
    if not same:
        raise AssertionError("in a group of one the sharded functions must equal the one-rank functions bit for bit")
    trainer = _build_trainer("cuda", warmup_steps=1, group=group)
    batch = to_device({k: v[:4] for k, v in batch_np.items()}, "cuda")
    _reset_counts()
    metrics = metrics_to_host(trainer.train_step(batch, 1))
    metrics.update(metrics_to_host(trainer.train_step(batch, 2)))
    torch.cuda.synchronize()
    counts = _counts()
    if not all(np.isfinite(v) for v in metrics.values()) or counts["vq_nearest_stats"] != 4:
        raise AssertionError(f"train steps under NCCL: metrics {metrics}, launches {counts}")
    if any(v["calls"] for v in mesh.collective_counts().values()):
        raise AssertionError(f"a group of one communicated: {mesh.collective_counts()}")
    return {"backend": dist.get_backend(group.pg), "control": dist.get_backend(group.control), "launches": counts,
            "g_loss": metrics["g_loss"], "d_loss": metrics["d_loss"]}


class _Beside(threading.Thread):
    """``fn(*args)`` on a thread of its own, beside what this thread does
    next; ``result()`` waits for it and raises what it raised."""

    def __init__(self, fn, *args):
        super().__init__(daemon=True)
        self.fn, self.args, self.out, self.error, self.seconds = fn, args, None, None, 0.0
        self.start()

    def run(self):
        t0 = time.perf_counter()
        try:
            self.out = self.fn(*self.args)
        except BaseException as e:  # raised again by result()
            self.error = e
        self.seconds = time.perf_counter() - t0

    def result(self):
        self.join()
        if self.error is not None:
            raise self.error
        return self.out


def phase_nccl(batch_np):
    from msmctts_tpu_torch.parallel.launch import run_ranks

    torch.cuda.empty_cache()
    res = run_ranks(rank_nccl, 1, "nccl", ["cuda:0"], batch_np, timeout_s=RANKS_TIMEOUT_S)[0]
    log(f"[9] NCCL at world size 1: backend {res['backend']} (control {res['control']}), raw all-reduce ok, sharded functions "
        f"bit-equal to the one-rank functions, one warmup + one GAN step through the group: launches {res['launches']}, "
        f"g_loss {res['g_loss']:.4f}, d_loss {res['d_loss']:.4f}")
    return res


def rank_train(group, device, batch_np, reference_indices, mesh_node=None, save_dir=None):
    """Phase 6's steps on this rank's rows of the global batch (its block of
    the data axis under tensor parallelism, ``mesh_node``). Where an
    assignment differs from the one-rank run's (``reference_indices``, one
    [B, T, H] per stage pass), the distance gap between the two codewords
    is recorded, under this rank's input and codebook. With ``save_dir`` the
    run ends with a checkpoint there (gathered, rank 0 writing)."""
    import hashlib

    from msmctts_tpu_torch.data.loader import to_device
    from msmctts_tpu_torch.parallel import mesh, sharding
    from msmctts_tpu_torch.training.base_trainer import metrics_to_host
    from msmctts_tpu_torch.weights import assert_replicated

    trainer = _build_trainer("cuda", warmup_steps=2, group=group, mesh_node=mesh_node)
    ae, disc = trainer.ae, trainer.disc
    assert_replicated([ae, disc], group)
    d_rank, d_world = trainer.rank, trainer.world  # the data axis: the rows
    batch = to_device(mesh.shard_rows(batch_np, d_rank, d_world), "cuda")
    indices, codebooks, flips, runner_up_gaps = [], [], [], []
    rows = slice(d_rank * TRAIN_B // d_world, (d_rank + 1) * TRAIN_B // d_world)
    old_embed = {}

    def before(q, args):
        old_embed[q] = q.embed.clone()  # the forward snaps to the codebook before its update

    def after(q, args, out, stage):
        idx = out[2]
        want = reference_indices[len(indices)][rows].to(idx.device)
        x = args[0].detach().float().reshape(-1, q.n_head, q.sub_dim)
        idx_f, want_f = idx.reshape(-1, q.n_head), want.reshape(-1, q.n_head)
        if not torch.equal(idx_f, want_f):
            gaps = _index_gaps(x, old_embed[q], idx_f, want_f)
            where = (idx_f != want_f).nonzero()
            frames = want.shape[1]  # of this stage: want is [rows, frames, heads]
            flips.extend({"pass": len(indices), "stage": stage, "head": int(h), "codewords": [int(idx_f[n, h]), int(want_f[n, h])],
                          "rel_gap": float(g), "row": rows.start + int(n) // frames}
                         for (n, h), g in zip(where, gaps))
        top2 = _distances(x, old_embed[q]).topk(2, dim=-1, largest=False).values
        runner_up_gaps.append(float(((top2[..., 1] - top2[..., 0]) / top2[..., 0].abs().clamp_min(1.0)).median()))
        indices.append(idx.cpu())

    hooks = []
    for stage, q in enumerate(ae.quantizer.quantizer):
        hooks.append(q.register_forward_pre_hook(before))
        hooks.append(q.register_forward_hook(lambda q, a, o, stage=stage: after(q, a, o, stage)))
    steps = []
    for it in range(1, 5):
        torch.cuda.synchronize()
        mesh.barrier(group)
        mesh.reset_collective_counts()
        sharding.PAIR_REDUCES[0] = 0
        _reset_counts()
        t0 = time.perf_counter()
        if mesh_node is not None and it == 4:  # kernel row 3's calls of the last step, to hold against plain
            box = {}
            stats_rows = _stats_rows(ae, lambda: box.update(metrics=trainer.train_step(batch, it)))
            metrics = box["metrics"]
        else:
            metrics = trainer.train_step(batch, it)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = _counts()
        steps.append({"iteration": it, "ms": ms, "metrics": metrics_to_host(metrics), "launches": launches,
                      "collectives": mesh.collective_counts(), "by_group": mesh.collective_counts(by_group=True),
                      "pair_reduces": sharding.PAIR_REDUCES[0]})
        codebooks.append(_codebook_state(ae))
    for h in hooks:
        h.remove()
    out = {"model_rank": mesh.rank(trainer.tp), "d_rank": d_rank}
    if trainer.tp is not None:
        out["stats"] = _hold_stats(stats_rows, f"rank {group.rank} (data {d_rank}, model {trainer.tp.rank}) GAN step 4",
                                   "[23]", timed=False, ties=True)
        out["pairs"] = {"fft": sum(type(m).__name__ != "ResBlock1" for m in trainer._plan.modules),
                        "mrf": sum(len(m.dilations) for m in trainer._plan.modules if type(m).__name__ == "ResBlock1"),
                        "marked": len(trainer._plan.marked), "kept_whole": sorted(trainer._plan.replicated)}
    trainer.unshard()  # the gathered state (a no-op without a model group)
    assert_replicated([ae, disc], group)  # parameters and codebooks bit-equal across ranks
    digest = hashlib.sha256()
    for t in list(ae.state_dict().values()) + list(disc.state_dict().values()):
        digest.update(t.detach().cpu().numpy().tobytes())
    if save_dir is not None:
        trainer.save_dir, trainer.iteration = save_dir, 4
        t0 = time.perf_counter()
        out["checkpoint"] = mesh.broadcast_object(trainer.save(), group)
        out["save_s"] = time.perf_counter() - t0
    return {**out, "steps": steps, "indices": indices, "codebooks": codebooks, "digest": digest.hexdigest(),
            "flips": flips, "median_runner_up_gap": runner_up_gaps}


def phase_dp_training(res, backend, reference, card):
    return _hold_dp_training(res, reference, backend, card, "[10]", f"{WORLD} ranks x {TRAIN_B // WORLD} rows")


def _hold_dp_training(res_all, reference, backend, card, tag, what, tol=DP_TOL):
    """Phase 10's holds of a run's ranks against phase 6's one-rank run
    (``reference``); under tensor parallelism the ranks of model rank 0
    hold the blocks of rows, to ``TP_TOL``."""
    res = sorted((r for r in res_all if r["model_rank"] == 0), key=lambda r: r["d_rank"])
    if len({r["digest"] for r in res_all}) != 1:
        raise AssertionError("data-parallel training: the ranks' final states differ")
    worst = {"loss_rel": 0.0, "codebook_abs": 0.0, "loss_rel_per_step": []}
    for step, want in zip(res[0]["steps"], reference["metrics"]):
        worst["loss_rel_per_step"].append(0.0)
        for k, w in want.items():
            got = step["metrics"][k]
            rel = abs(got - w) / max(abs(w), 1e-3)
            worst["loss_rel"] = max(worst["loss_rel"], rel)
            worst["loss_rel_per_step"][-1] = max(worst["loss_rel_per_step"][-1], rel)
            if rel > STEP_TOL["loss_rtol"]:
                raise AssertionError(f"data-parallel step {step['iteration']}, {k}: {WORLD} ranks {got} vs one rank {w}")
    for r in res_all[1:]:
        if [s["metrics"] for s in r["steps"]] != [s["metrics"] for s in res[0]["steps"]]:
            raise AssertionError("data-parallel training: the ranks report different metrics")
    # Assignments. Step 1 starts from equal state, so its indices must be equal.
    # Later steps see weights that differ by rounding (cuDNN's choices at batch 8
    # and at batch 16), so an assignment between two codewords at nearly equal
    # distance may fall the other way: each such is shown with its distance gap,
    # held to ``tol``, and only the codewords it touches may then differ. A
    # later stage's input is built from the earlier stage's codes of the same
    # utterance, so a flip there changes that utterance's input to the later
    # stage of the same step: the later stage's flips in that utterance follow
    # from it at any gap, and only the flips that follow from none are held.
    flips = [int((torch.cat([r["indices"][i] for r in res]) != want).sum()) for i, want in enumerate(reference["indices"])]
    assignments = sum(want.numel() for want in reference["indices"])
    same = flips[0] == 0 and flips[1] == 0
    flipped = [f for r in res for f in r["flips"]]
    if len(flipped) != sum(flips):
        raise AssertionError(f"data-parallel training: {sum(flips)} assignments differ, the ranks recorded {len(flipped)}")
    stages = len(reference["codebooks"][0])
    roots = [f for f in flipped if not any(g["pass"] // stages == f["pass"] // stages and g["stage"] < f["stage"]
                                           and g["row"] == f["row"] for g in flipped)]
    touched = [torch.zeros_like(reference["codebooks"][0][s][1], dtype=torch.bool) for s in range(stages)]  # [H, K] each
    for f in flipped:
        touched[f["stage"]][f["head"], f["codewords"]] = True

    def codebook_diff(step, untouched_only=False, per_cluster_size=False):
        """max abs difference of (embed, cluster_size, embed_avg) over the stages. ``embed_avg`` is a codeword
        times its cluster size (hundreds in a trained codebook); ``per_cluster_size`` divides its difference by
        that size (floor 1), which is what reaches the codeword."""
        out = [0.0, 0.0, 0.0]
        for s, (a, b) in enumerate(zip(res[0]["codebooks"][step], reference["codebooks"][step])):
            keep = ~touched[s] if untouched_only else torch.ones_like(touched[s])
            for i in range(3):
                diff = (a[i] - b[i]).abs()
                if i == 2 and per_cluster_size:
                    diff = diff / b[1].clamp_min(1.0)[:, None, :]
                diff = diff * (keep if diff.dim() == 2 else keep[:, None, :])
                out[i] = max(out[i], float(diff.max()))
        return out

    first, last = codebook_diff(0), codebook_diff(3)
    last_untouched_abs = codebook_diff(3, untouched_only=True)
    last_untouched = codebook_diff(3, untouched_only=True, per_cluster_size=True)
    sizes = [float(b[1].max()) for b in reference["codebooks"][3]]
    worst["codebook_abs"] = max(first)
    for r in res_all:
        for step in r["steps"]:
            want = {"vq_nearest": 0, "vq_nearest_stats": 2, "fused_resblock_layer": 0}
            if step["launches"] != want:
                raise AssertionError(f"data-parallel step {step['iteration']}: launches {step['launches']}, expected {want}")
    per_step = [{k: v for k, v in s["collectives"].items() if v["calls"]} for s in res[0]["steps"]]
    log(f"{tag} {what} vs one rank x {TRAIN_B}, dropout on, 2 warmup + 2 GAN steps (backend {backend}): "
        f"first-step indices equal {same}, worst metric rel diff {worst['loss_rel']:.3g} (per step "
        f"{[float(f'{v:.3g}') for v in worst['loss_rel_per_step']]}); codebook after the first step "
        f"(embed, cluster_size, embed_avg) within {first}; parameters and codebooks bit-equal across ranks; "
        f"2 vq_stats launches per step per rank")
    log(f"{tag} assignments that differ, per stage pass of steps 1-4: {flips} of {assignments}, {len(roots)} of them not "
        f"following from an earlier stage's flip in the same step and utterance; each with the relative distance "
        f"gap between its two codewords: {json.dumps(flipped)}; median gap to the runner-up over all rows, per stage pass: "
        f"{[round(g, 4) for g in res[0]['median_runner_up_gap']]}")
    log(f"{tag} codebook after the last step (embed, cluster_size, embed_avg per unit of cluster size): within {last_untouched} on the "
        f"{sum(int((~t).sum()) for t in touched)} codewords no differing assignment touches (embed_avg itself within "
        f"{last_untouched_abs[2]}, cluster sizes up to {[round(v, 1) for v in sizes]}); (embed, cluster_size, embed_avg) within {last} on all")
    log(f"{tag} collectives per step per rank: {json.dumps(per_step)}")
    log(f"{tag} step wall per rank, {len(res_all)} processes time-slicing {card} (no scaling figure): "
        f"{[[round(s['ms'], 1) for s in r['steps']] for r in res_all]} ms")
    if not same or worst["codebook_abs"] > STEP_TOL["codebook_atol"]:
        raise AssertionError(f"data-parallel training disagrees with one rank after the first step: indices equal {same}, {first}")
    wide = [f for f in roots if f["rel_gap"] > tol["flip_rel_gap"]]
    if len(roots) > tol["max_flips"] or wide:
        raise AssertionError(f"data-parallel training drifts from one rank: {len(roots)} assignments differ (and "
                             f"{len(flipped) - len(roots)} follow from them), not near-ties: {wide}")
    if max(last_untouched) > tol["last_codebook_atol"]:
        raise AssertionError(f"data-parallel training drifts from one rank: codebook after the last step within {last_untouched} "
                             "on codewords that no differing assignment touches")
    launches = sum(s["launches"]["vq_nearest_stats"] for s in res[0]["steps"])
    return {**worst, "indices_equal": same, "assignments_differing": flips, "flipped": flipped,
            "flips_following": len(flipped) - len(roots), "codebook_diff_first_step": first,
            "codebook_diff_last_step": last, "codebook_diff_last_step_untouched": last_untouched,
            "embed_avg_diff_last_step_untouched": last_untouched_abs[2],
            "median_runner_up_gap": res[0]["median_runner_up_gap"], "backend": backend, "collectives_per_step": per_step, "sharded_launches": launches,
            "steps": [r["steps"] for r in res_all]}


def _load_tts_task(am_path, device):
    from msmctts_tpu_torch.config import Config
    from msmctts_tpu_torch.tasks import build_task
    from msmctts_tpu_torch.utils.checkpoint import load_checkpoint

    ck = load_checkpoint(am_path)
    task = build_task(Config(ck["config"]), device=device)
    task.load_variables(ck["state"])
    task.pre_infer()
    return task


def _stream_batch(n_symbols, Lt):
    """Phase 13's streamed batch: 4 texts, forced durations of 4-6 frames a
    phone, the longest over at least 4 chunks of 64 frames."""
    rng = np.random.default_rng(13)
    n_phones = [64, 57, 40, 33]
    dur = rng.integers(4, 7, size=(SERVE_B, Lt)).astype(np.float32) * (np.arange(Lt)[None] < np.array(n_phones)[:, None])
    return {"text": _text(rng, n_phones, n_symbols, Lt), "text_length": np.array(n_phones), "dur": dur}


GROUP_TEXTS = 3  # requests of the group engine: one alone, then all together


def rank_predict(group, device, am_path, batch, engine_texts):
    """On this rank of the inference group: ``predict`` of the global batch;
    with the int8 decoder (its scales calibrated on the gathered batch); a
    streamed batch (4 + 36 launches a window, both kernels held against
    plain on this rank's inputs and shapes); then a ``BatchingEngine`` over
    the group (rank 0 serves, the other rank follows): warmup, the first
    text alone, then every text in one batch."""
    from msmctts_tpu_torch.ops import cuda_build
    from msmctts_tpu_torch.ops.int8_generator import LAUNCHES
    from msmctts_tpu_torch.parallel import mesh
    from msmctts_tpu_torch.serving import BatchingEngine

    task = _load_tts_task(am_path, "cuda").use_mesh(group)
    ae = task.networks["autoencoder"]
    task.predict(batch)  # warm-up
    torch.cuda.synchronize()
    mesh.barrier(group)
    mesh.reset_collective_counts()
    _reset_counts()
    t0 = time.perf_counter()
    out = task.predict(batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    res = {"out": out, "launches": _counts(), "collectives": mesh.collective_counts(), "ms": ms}

    # --int8: calibrated on the global batch's decoder inputs, gathered to every rank
    task.int8_decoder = True
    _reset_counts()
    LAUNCHES["int8_conv1d"] = 0
    snaps = _snap_rows(ae, lambda: res.update(int8=task.predict(batch)))
    res["int8_launches"] = {**_counts(), "int8_conv1d": LAUNCHES["int8_conv1d"]}
    res["int8_scales"] = dict(task._int8_state.scales)
    res["int8_snaps"] = _hold_snaps(snaps, f"rank {group.rank} int8 predict", "[11]")
    task.int8_decoder = False

    # a streamed batch: this rank's windows, every chunk gathered
    gen = torch.Generator(device="cuda").manual_seed(11 + group.rank)
    eng = BatchingEngine(task, sample_rate=task.samplerate, batch_size=SERVE_B, window_ms=200.0,
                         max_frames=SERVE_MAX_FRAMES, stream_chunk_frames=SERVE_CHUNK, group=group)
    sbatch = _stream_batch(list(task.networks["predictor"].n_symbols), eng.text_length)
    _reset_counts()
    mesh.reset_collective_counts()
    t0 = time.perf_counter()
    snaps = _snap_rows(ae, lambda: res.update(stream_meta=task.predict_stream(sbatch, chunk_frames=SERVE_CHUNK)))
    meta, chunks = res.pop("stream_meta")
    pieces = list(chunks)
    res["stream_ms"] = (time.perf_counter() - t0) * 1e3
    res["stream"] = np.concatenate(pieces, axis=1)
    res["stream_wav_length"] = meta["wav_length"]
    res["stream_launches"] = _counts()
    res["stream_windows"] = len(pieces)
    res["stream_collectives"] = mesh.collective_counts()
    res["stream_snaps"] = _hold_snaps(snaps, f"rank {group.rank} streamed batch", "[11]")
    res["stream_window"] = _hold_window_layers(gen, task._streaming_decoder(SERVE_CHUNK).window_frames,
                                               SERVE_B // group.world)

    # the engine over the group; each rank counts its kernel launches (a
    # follower's over its whole loop: the warmup's, then the served batches')
    _reset_counts()
    if group.rank != 0:
        eng.follow()
        res["engine"] = {"cold_shapes": eng._own_cold_shapes(), "kernel_builds": eng._own_kernel_builds(),
                         "launches": _counts()}
        return res
    t0 = time.perf_counter()
    eng.start(warmup={})
    warm_s = time.perf_counter() - t0
    warm_launches = _counts()
    _reset_counts()
    try:
        alone = eng.synthesize(engine_texts[0], timeout=SERVE_TIMEOUT_S)
        import threading

        together = [None] * len(engine_texts)

        def ask(i):
            together[i] = eng.synthesize(engine_texts[i], timeout=SERVE_TIMEOUT_S)

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(engine_texts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(SERVE_TIMEOUT_S)
        for _ in range(100):  # a batch is counted just after its requests are answered
            stats = eng.snapshot()
            if stats["requests"] >= 1 + len(engine_texts):
                break
            time.sleep(0.01)
        served_launches = _counts()
    finally:
        eng.stop()
    res["engine"] = {"warm_s": warm_s, "alone": alone, "together": together, "stats": stats,
                     "warm_launches": warm_launches, "launches": served_launches,
                     "shapes": len(eng._warm_shapes), "margin": task.frame_margin,
                     "builds_since_warmup": cuda_build.build_count() - eng._warm_builds}
    return res


def phase_dp_inference(res, backend, reference):
    """Phase 11: ``predict`` over the group, then, on the same ranks,
    ``--int8`` ``predict``, a streamed batch and a ``BatchingEngine`` over
    the group (``res``), each held against one rank's run on the same
    global batch in this process."""
    from msmctts_tpu_torch.serving import BatchingEngine, parse_phone_string

    one = _load_tts_task(reference["am_path"], "cuda")
    n_symbols = list(one.networks["predictor"].n_symbols)
    texts = _group_texts(n_symbols)
    want = reference["out"]
    worst = 0.0
    for r in res:
        got = r["out"]
        same = (np.array_equal(got["duration"], want["duration"]) and np.array_equal(got["mel_length"], want["mel_length"])
                and all(np.array_equal(a, b) for a, b in zip(got["embedding"], want["embedding"])))
        if not same:
            raise AssertionError("data-parallel predict: durations or codewords differ from one rank's")
        for a, b in zip(got["wav"], want["wav"]):
            if a.shape != b.shape:
                raise AssertionError(f"data-parallel predict: wav of {a.shape} vs {b.shape}")
            worst = max(worst, float(np.abs(a - b).max()))
        expected = {"vq_nearest": 4, "vq_nearest_stats": 0, "fused_resblock_layer": 36}
        if r["launches"] != expected:
            raise AssertionError(f"data-parallel predict: launches {r['launches']}, expected {expected}")
        if r["collectives"]["all_reduce"]["calls"]:
            raise AssertionError(f"data-parallel predict: the snaps communicated: {r['collectives']}")
    if worst > AS_TOL:
        raise AssertionError(f"data-parallel predict: wav differs from one rank's by {worst}")
    log(f"[11] predict B={len(want['wav'])} over {WORLD} ranks (backend {backend}) vs one rank: durations and codewords equal, "
        f"wav max abs diff {worst:.3g}; per rank 4 VQ + 36 MRF launches, collectives "
        f"{ {k: v for k, v in res[0]['collectives'].items() if v['calls']} }; wall per rank {[round(r['ms'], 1) for r in res]} ms "
        "(two processes on one card: no scaling figure)")

    # --int8 against one rank's int8 predict of the same global batch
    one.int8_decoder = True
    want8 = one.predict(reference["batch"])
    scales = one._int8_state.scales
    one.int8_decoder = False
    int8_err, scale_rel = 0.0, 0.0
    for r in res:
        scale_rel = max(scale_rel, max(abs(r["int8_scales"][k] - v) / v for k, v in scales.items()))
        if sorted(r["int8_scales"]) != sorted(scales) or r["int8_scales"] != res[0]["int8_scales"]:
            raise AssertionError("int8 over the group: the ranks' scales differ")
        for a, b in zip(r["int8"]["wav"], want8["wav"]):
            if a.shape != b.shape:
                raise AssertionError(f"int8 over the group: wav of {a.shape} vs {b.shape}")
            int8_err = max(int8_err, float(np.abs(a - b).max()))
        if r["int8_launches"]["vq_nearest"] != 4 or r["int8_launches"]["fused_resblock_layer"]:
            raise AssertionError(f"int8 over the group: launches {r['int8_launches']}")
    log(f"[11] --int8 predict over {WORLD} ranks vs one rank: {len(scales)} site scales, equal on every rank, "
        f"vs one rank's max relative diff {scale_rel:.3g} (bit-equal {res[0]['int8_scales'] == scales}); wav max abs diff "
        f"{int8_err:.3g} (bound {INT8_GROUP_TOL}); launches per rank {res[0]['int8_launches']} (with calibration's products)")
    if int8_err > INT8_GROUP_TOL or scale_rel > INT8_SCALE_RTOL:
        raise AssertionError(f"int8 over the group: wav {int8_err}, scales {scale_rel} from one rank's")

    # the streamed batch against one rank's stream
    eng1 = BatchingEngine(one, sample_rate=one.samplerate, batch_size=SERVE_B, window_ms=0.0,
                          max_frames=SERVE_MAX_FRAMES, stream_chunk_frames=SERVE_CHUNK)
    sbatch = _stream_batch(n_symbols, eng1.text_length)
    stream1 = np.concatenate(list(one.predict_stream(sbatch, chunk_frames=SERVE_CHUNK)[1]), axis=1)
    stream_err = 0.0
    for r in res:
        want_counts = {"vq_nearest": 4, "vq_nearest_stats": 0, "fused_resblock_layer": 36 * r["stream_windows"]}
        if r["stream_launches"] != want_counts or r["stream_windows"] < 4:
            raise AssertionError(f"streamed batch over the group: launches {r['stream_launches']}, "
                                 f"{r['stream_windows']} windows")
        if r["stream"].shape != stream1.shape:
            raise AssertionError(f"streamed batch over the group: {r['stream'].shape} vs one rank's {stream1.shape}")
        for i, n in enumerate(r["stream_wav_length"]):
            stream_err = max(stream_err, float(np.abs(r["stream"][i, :n] - stream1[i, :n]).max()))
    log(f"[11] streamed batch over {WORLD} ranks: {res[0]['stream_windows']} windows, launches per rank "
        f"{res[0]['stream_launches']} (36 MRF a window), chunks gathered "
        f"{res[0]['stream_collectives']['all_gather']['calls']} times; concatenated vs one rank's stream max abs diff "
        f"{stream_err:.3g}; per rank kernel 5 at the window's 36 layers of {SERVE_B // WORLD} rows: max abs err "
        f"{max(r['stream_window']['max_abs_err'] for r in res):.3g}; stream wall per rank "
        f"{[round(r['stream_ms'], 1) for r in res]} ms")
    if stream_err > AS_TOL:
        raise AssertionError(f"streamed batch over the group differs from one rank's by {stream_err}")

    # the engine over the group: each rank warm, a request equal to itself alone and to one rank's predict
    e0, e1 = res[0]["engine"], res[1]["engine"]
    solo = one.predict(eng1.batch_of([parse_phone_string(texts[0])]))
    engine_err = float(np.abs(e0["together"][0] - e0["alone"]).max()) if e0["together"][0].shape == e0["alone"].shape \
        else float("inf")
    solo_err = float(np.abs(e0["alone"] - solo["wav"][0]).max()) if e0["alone"].shape == solo["wav"][0].shape else float("inf")
    stats = e0["stats"]
    # launches per served batch on each rank: rank 0 counted from its warmup's end, the
    # follower over its loop less the warmup, which every rank runs alike
    per_batch = {"vq_nearest": 4, "vq_nearest_stats": 0, "fused_resblock_layer": 36}
    want_launches = {k: v * stats["batches"] for k, v in per_batch.items()}
    follower_served = {k: e1["launches"][k] - e0["warm_launches"][k] for k in per_batch}
    log(f"[11] BatchingEngine over {WORLD} ranks: warmup {e0['warm_s']:.2f}s, {e0['shapes']} shapes, frame margin "
        f"{e0['margin']}; /stats ranks {json.dumps(stats['ranks'])}, batches {stats['batches']}, requests "
        f"{stats['requests']}; launches over the served batches, rank 0 {e0['launches']}, rank 1 {follower_served}; "
        f"a request in a batch of {len(texts)} vs alone max abs diff {engine_err:.3g}, alone vs one "
        f"rank's predict of the same padded batch {solo_err:.3g}")
    if e0["launches"] != want_launches or follower_served != want_launches:
        raise AssertionError(f"the engine over the group: launches over {stats['batches']} batches, rank 0 "
                             f"{e0['launches']}, rank 1 {follower_served}, expected {want_launches}")
    if stats["cold_shapes"] or stats["kernel_builds"] or e1["cold_shapes"] or e1["kernel_builds"] or stats["errors"] \
            or engine_err > AS_TOL or solo_err > AS_TOL or stats["requests"] != 1 + len(texts):
        raise AssertionError(f"the engine over the group: /stats {stats}, follower {e1}, request vs alone {engine_err}, "
                             f"vs one rank {solo_err}")
    del one
    torch.cuda.empty_cache()
    return {"wav_err": worst, "launches": res[0]["launches"], "collectives": res[0]["collectives"], "ms": [r["ms"] for r in res],
            "int8": {"wav_err": int8_err, "scale_rel": scale_rel, "launches": res[0]["int8_launches"],
                     "snaps": res[0]["int8_snaps"]},
            "stream": {"err": stream_err, "windows": res[0]["stream_windows"], "launches": res[0]["stream_launches"],
                       "snaps": res[0]["stream_snaps"], "window": res[0]["stream_window"]},
            "engine": {"warm_s": e0["warm_s"], "stats": stats, "request_vs_alone": engine_err, "vs_one_rank": solo_err,
                       "launches": {"rank0": e0["launches"], "rank1": follower_served, "batches": stats["batches"]}}}


# ------------------------------------------------- acoustic-model training


def _am_batch(rng, n_symbols, B, Lt, T, phones, frames, n_mel=80):
    """Seeded text/dur/mel, padded as ``TTSDataset`` pads them (text and dur
    0, mel -4): ``phones`` and ``frames`` bound the lengths, the first row
    takes both maxima, and each utterance's durations are positive integers
    summing to its frame count."""
    n_phones = rng.integers(phones[0], phones[1] + 1, size=B)
    n_frames = rng.integers(frames[0], frames[1] + 1, size=B)
    n_phones[0], n_frames[0] = phones[1], frames[1]
    dur = np.zeros((B, Lt), np.float32)
    for i, (n, f) in enumerate(zip(n_phones, n_frames)):
        cuts = np.sort(rng.choice(np.arange(1, f), size=n - 1, replace=False))
        dur[i, :n] = np.diff(np.concatenate([[0], cuts, [f]]))
    valid = np.arange(T)[None, :] < n_frames[:, None]
    mel = np.where(valid[..., None], rng.normal(size=(B, T, n_mel)) * 0.5, -4.0).astype(np.float32)
    return {"text": _text(rng, n_phones, n_symbols, Lt).astype(np.int32), "text_length": n_phones.astype(np.int32),
            "dur": dur, "mel": mel, "mel_length": n_frames.astype(np.int32)}


def _am_config(dropout=None, precision=None):
    """The CSMSC AM recipe with the fixture's trained autoencoder as its
    teacher (the fixture's embedded config)."""
    from msmctts_tpu_torch.config import Config

    cfg = Config(AM_YAML)
    if precision is not None:
        cfg["precision"] = precision
    cfg.task["autoencoder"]["_checkpoint"] = FIXTURE
    cfg.task["autoencoder"].pop("_config", None)
    cfg["save_checkpoint_dir"] = os.path.join(SMOKE_DIR, "ckpt_am")
    if dropout is not None:
        p = cfg.task["predictor"]
        for node in (p["encoder_config"], p["decoder_config"]):
            node["dropout"] = node["attn_dropout"] = dropout
        p["adaptor_config"]["dropout"] = dropout
    return cfg


def _build_am_trainer(device, dropout=None, precision=None, group=None, mesh_node=None):
    from msmctts_tpu_torch.config import component_kwargs
    from msmctts_tpu_torch.registry import get_trainer
    from msmctts_tpu_torch.tasks import build_task

    cfg = _am_config(dropout, precision)
    if mesh_node is not None:
        cfg["mesh"] = dict(mesh_node)
    task = build_task(cfg, device=device, mode="train")
    trainer = get_trainer(cfg.trainer["_name"])(cfg, task, group=group, **component_kwargs(cfg.trainer))
    trainer.init_state()  # seeded; the teacher loads at the first step
    return trainer


def phase_am_training(card, with_profile=False):
    from msmctts_tpu_torch.data.loader import to_device
    from msmctts_tpu_torch.ops import vq
    from msmctts_tpu_torch.training.base_trainer import metrics_to_host

    torch.cuda.empty_cache()
    base_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    trainer = _build_am_trainer("cuda")
    predictor, ae = trainer.predictor, trainer.frozen_autoencoder()
    n_params = sum(p.numel() for p in predictor.parameters())
    n_symbols = list(trainer.config.task["predictor"]["n_symbols"])
    batch_np = _am_batch(np.random.default_rng(1234), n_symbols, AM_B, AM_TEXT, AM_FRAMES, AM_PHONES, AM_LENGTHS)
    batch = to_device(batch_np, "cuda")
    teacher0 = {k: v.clone() for k, v in ae.state_dict().items()}
    log(f"[12] CSMSC acoustic model {n_params / 1e6:.1f}M parameters, teacher {sum(p.numel() for p in ae.parameters()) / 1e6:.1f}M "
        f"(fixture); batch {AM_B}, phones {batch_np['text_length'].min()}-{batch_np['text_length'].max()} (bucket {AM_TEXT}), "
        f"frames {batch_np['mel_length'].min()}-{batch_np['mel_length'].max()} (bucket {AM_FRAMES}), dropout on")

    snaps = []  # per step: the teacher's stage inputs and indices
    pre = [q.register_forward_pre_hook(lambda m, a: snaps.append({"x": a[0].detach().reshape(-1, m.n_head, m.sub_dim)}))
           for q in ae.quantizer.quantizer]
    post = [q.register_forward_hook(lambda m, a, o: snaps[-1].update(idx=o[2].reshape(-1, m.n_head), embed=m.embed))
            for q in ae.quantizer.quantizer]
    steps = []
    for it in range(1, AM_STEPS + 1):
        before = [p.detach().clone() for p in predictor.parameters()]
        snaps.clear()
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch, it)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = _counts()
        host = metrics_to_host(metrics)
        bad = [k for k, v in host.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"AM step {it}: non-finite metrics {bad}")
        if counts != {"vq_nearest": 2, "vq_nearest_stats": 0, "fused_resblock_layer": 0}:
            raise AssertionError(f"AM step {it}: launches {counts}, expected the teacher's 2 vq_nearest snaps only")
        moved = _moved(predictor, before)
        if moved < 0.9 * len(before):
            raise AssertionError(f"AM step {it}: only {moved} of {len(before)} predictor tensors moved")
        steps.append({"iteration": it, "ms": ms, "metrics": host, "launches": counts, "tensors_moved": moved})
        log(f"[12] AM step {it}: {ms:.1f} ms, launches {counts}, moved {moved}/{len(before)} tensors, "
            f"{ {k: round(v, 4) for k, v in sorted(host.items())} }")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for h in pre + post:
        h.remove()
    changed = [k for k, v in ae.state_dict().items() if not torch.equal(v, teacher0[k])]
    if changed or ae.training:
        raise AssertionError(f"the teacher changed: {changed[:5]} (training mode {ae.training})")

    # the teacher's snap at its two N, from the last step's inputs: the kernel against its plain version
    snap_rows = []
    for stage, s in enumerate(snaps):
        x, e = s["x"].contiguous(), s["embed"]
        idx, quant = vq.vq_nearest(x, e)
        ref_idx, ref_quant = vq.vq_nearest_plain(x, e)
        torch.cuda.synchronize()
        if not torch.equal(idx, s["idx"]):
            raise AssertionError(f"AM teacher stage {stage}: the step's indices differ from a second launch")
        err, mismatches = _hold_snap(f"AM teacher snap stage {stage}", x, e, idx, quant, ref_idx, ref_quant)
        N = x.shape[0]
        dev = device_profile(lambda: vq.vq_nearest(x, e))
        b = _snap_bound(N)
        snap_rows.append({"stage": stage, "N": N, "index_mismatches": mismatches, "max_abs_err": err,
                          "device_ms": dev["ms"], "ms": time_ms(lambda: vq.vq_nearest(x, e), runs=20),
                          "plain_ms": time_ms(lambda: vq.vq_nearest_plain(x, e), runs=20), "bound_ms": b[0], "bound_by": b[1]})
        log(f"[12] teacher snap stage {stage} N={N}: vs plain {mismatches} indices differ (equal distances), codewords "
            f"max abs err {err}; device {dev['ms']:.4f} ms per launch, events {snap_rows[-1]['ms']:.4f}, plain "
            f"{snap_rows[-1]['plain_ms']:.4f}, bound {b[0]:.4f} ({b[1]})")

    def timed(it):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch, it)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    warm = [timed(AM_STEPS + 1 + i) for i in range(5)]
    warm_ms = statistics.median(warm)
    # the step's matmul and convolution operations, forward and backward, as PyTorch dispatches them
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        trainer.train_step(batch, AM_STEPS + 6)
    flops = counter.get_total_flops()
    snap_ms = sum(r["device_ms"] for r in snap_rows)
    result = {
        "steps": steps, "first_ms": steps[0]["ms"], "warm_ms": warm_ms, "warm_runs_ms": warm,
        "peak_memory_gib": peak_gib, "peak_above_start_gib": peak_gib - base_gib, "am_params": n_params,
        "launches_per_step": steps[-1]["launches"], "snap": snap_rows, "snap_device_ms_per_step": snap_ms,
        "snap_share_of_warm_step": snap_ms / warm_ms, "flops": flops, "bound_ms": flops / PEAK_FP32 * 1e3,
        "tflops": flops / warm_ms / 1e9,
    }
    log(f"[12] per AM step on {card}: first {result['first_ms']:.1f} ms, warm median {warm_ms:.1f} ms "
        f"(runs {[round(w, 1) for w in warm]}); peak memory {peak_gib:.2f} GiB ({peak_gib - base_gib:.2f} above the "
        f"phase's start); {flops / 1e12:.2f} TFLOP of matmuls and convolutions, {result['tflops']:.1f} TFLOP/s, bound "
        f"{result['bound_ms']:.1f} ms at fp32 peak; the teacher's 2 snaps {snap_ms:.4f} ms on the device, "
        f"{result['snap_share_of_warm_step']:.3%} of the step; teacher parameters and codebooks bit-equal before and after")
    if with_profile:
        result["profile"] = profile_call(lambda: trainer.train_step(batch, 20), "[12]", "AM step")
    return result


def phase_am_step_card_vs_cpu():
    """One AM step from identical state and batch on the card and on the
    CPU: full width, 2 short utterances, dropout 0."""
    from msmctts_tpu_torch.data.loader import to_device
    from msmctts_tpu_torch.training.base_trainer import metrics_to_host

    n_symbols = list(_am_config().task["predictor"]["n_symbols"])
    batch = _am_batch(np.random.default_rng(8), n_symbols, 2, 16, 64, (9, 16), (40, 60))
    out = {}
    for device in ("cuda", "cpu"):
        trainer = _build_am_trainer(device, dropout=0.0)
        indices = []
        hooks = [q.register_forward_hook(lambda m, a, o: indices.append(o[2].cpu()))
                 for q in trainer.frozen_autoencoder().quantizer.quantizer]
        out[device] = {"metrics": metrics_to_host(trainer.train_step(to_device(batch, device), 1)), "indices": indices}
        for h in hooks:
            h.remove()
        del trainer
    worst = 0.0
    for k, want in out["cpu"]["metrics"].items():
        got = out["cuda"]["metrics"][k]
        rel = abs(got - want) / max(abs(want), 1e-3)
        worst = max(worst, rel)
        if rel > STEP_TOL["loss_rtol"]:
            raise AssertionError(f"AM step, {k}: card {got} vs CPU {want}")
    same = all(torch.equal(a, b) for a, b in zip(out["cuda"]["indices"], out["cpu"]["indices"]))
    log(f"[12] one AM step, card vs CPU (B=2, frames {batch['mel_length'].tolist()}): teacher indices equal {same}, "
        f"worst metric rel diff {worst:.3g} over {sorted(out['cpu']['metrics'])}")
    if not same:
        raise AssertionError("AM step: the teacher's indices differ between the card and the CPU")
    return {"loss_rel": worst, "indices_equal": same, "card": out["cuda"]["metrics"], "cpu": out["cpu"]["metrics"]}


def _write_am_corpus(d, n_symbols, n_utts=16, seed=5):
    """A small TTSDataset corpus: phone.txt / dur.txt books, mel/*.npy, train.list."""
    rng = np.random.default_rng(seed)
    b = _am_batch(rng, n_symbols, n_utts, 48, 256, (12, 48), (60, 250))
    os.makedirs(os.path.join(d, "mel"), exist_ok=True)
    ids, phones, durs = [], [], []
    for i in range(n_utts):
        uid = f"am{i:03d}"
        n, f = int(b["text_length"][i]), int(b["mel_length"][i])
        ids.append(uid)
        phones.append(uid + "|" + " ".join("_".join(str(v) for v in row) for row in b["text"][i, :n]))
        durs.append(uid + "|" + " ".join(str(int(v)) for v in b["dur"][i, :n]))
        np.save(os.path.join(d, "mel", f"{uid}.npy"), b["mel"][i, :f])
    for name, lines in (("train.list", ids), ("phone.txt", phones), ("dur.txt", durs)):
        with open(os.path.join(d, name), "w") as fh:
            fh.write("\n".join(lines) + "\n")


def phase_am_entry_point(card):
    """The train entry point (``msmctts_tpu_torch.train.main``, in process) on
    the AM recipe for 2 steps at batch 8 on a corpus written here, with the
    teacher's snaps counted, then ``predict`` from its checkpoint."""
    import shutil

    import yaml

    from msmctts_tpu_torch.config import Config
    from msmctts_tpu_torch.tasks import build_task
    from msmctts_tpu_torch.utils.checkpoint import load_checkpoint

    d = os.path.join(SMOKE_DIR, "am_corpus")
    cfg = _am_config()
    n_symbols = list(cfg.task["predictor"]["n_symbols"])
    _write_am_corpus(d, n_symbols)
    cfg["save_checkpoint_dir"] = os.path.join(SMOKE_DIR, "ckpt_am_cli")
    shutil.rmtree(cfg["save_checkpoint_dir"], ignore_errors=True)
    cfg["dataloader"] = {"batch_size": 8, "num_workers": 2}
    cfg.dataset["id_list"] = os.path.join(d, "train.list")
    cfg.dataset["feature_path"] = [os.path.join(d, "phone.txt"), os.path.join(d, "dur.txt"), os.path.join(d, "mel", "{}.npy")]
    cfg_path = os.path.join(SMOKE_DIR, "am_cli.yaml")
    with open(cfg_path, "w") as fh:
        yaml.safe_dump(cfg.to_dict(), fh)
    from msmctts_tpu_torch import train

    # in process (phase 18 runs the CLI's own process): the steps' teacher
    # snaps behind the feed's prefetcher are counted
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    trainer = train.main(["-c", cfg_path, "--max-steps", "2", "--log-every", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_counts = _counts()
    del trainer
    torch.cuda.empty_cache()
    path = os.path.join(cfg["save_checkpoint_dir"], "model_2")
    logs = [f for f in os.listdir(cfg["save_checkpoint_dir"]) if f.endswith(".log")]
    text = "".join(open(os.path.join(cfg["save_checkpoint_dir"], f)).read() for f in logs)
    if "step 2" not in text or not os.path.exists(path):
        raise AssertionError(f"the train entry point wrote no step 2 / model_2:\n{text[-4000:]}")
    if train_counts != {"vq_nearest": 4, "vq_nearest_stats": 0, "fused_resblock_layer": 0}:
        raise AssertionError(f"2 AM steps through train(): launches {train_counts}, expected the teacher's 2 snaps a step")
    last = [line for line in text.splitlines() if "step 2" in line][-1]
    log(f"[12] train entry point, in process, 2 AM steps at batch 8 ({wall:.1f}s with start-up and checkpoint; launches "
        f"{train_counts}): {last.strip()}")

    ck = load_checkpoint(path)
    task = build_task(Config(ck["config"]), device="cuda")
    task.load_variables(ck["state"])
    rng = np.random.default_rng(6)
    b = _am_batch(rng, n_symbols, 2, 32, 128, (10, 32), (50, 120))
    req = {"text": b["text"], "text_length": b["text_length"], "dur": b["dur"]}
    _reset_counts()
    out = task.infer_step(req)
    torch.cuda.synchronize()
    counts = _counts()
    ratio = task.networks["autoencoder"].frameshift_ratio
    _check_wavs(out["wav"], b["mel_length"], ratio, "predict from the trained AM checkpoint")
    if counts != {"vq_nearest": 4, "vq_nearest_stats": 0, "fused_resblock_layer": 36}:
        raise AssertionError(f"predict from the AM checkpoint: launches {counts}, expected 4 VQ and 36 resblock")
    log(f"[12] predict from {os.path.relpath(path, ROOT)} on {card} (durations given, frames {b['mel_length'].tolist()}): "
        f"wav {[w.shape[0] for w in out['wav']]} samples, launches {counts}")
    return {"wall_s": wall, "last_line": last.strip(), "predict_launches": counts, "train_launches": train_counts}


# ------------------------------------------------------------- serving
# Phase 13: the inference entry points at the CSMSC AM recipe's full width
# (phase 5's seeded predictor, the fixture's autoencoder): the batching
# engine and the streaming decode in this process, then the HTTP daemon as a
# subprocess under concurrent load.
# the engines (in process and the daemon) keep the default text length, 256 phones
SERVE_B, SERVE_MAX_FRAMES, SERVE_CHUNK = 4, 512, 64
SERVE_REQUESTS, SERVE_CLIENTS, SERVE_PHONES = 16, 8, (24, 57)
SERVE_TIMEOUT_S = 300.0
INT8_GROUP_TOL = 1e-2  # int8 over the group vs one rank: the bound test_torch_int8.py holds a predict to
INT8_SCALE_RTOL = 1e-5  # the scales calibrated on the gathered batch vs one rank's on the same batch


def _phone_string(row):
    return " ".join("_".join(str(int(v)) for v in tok) for tok in row)


def _hold_window_layers(gen, window, batch, stages=STAGES):
    """Kernel 5 against its plain version at the window decode's 36 layers
    (``batch`` rows of ``window`` frames), times summed per window decode."""
    rows, worst = _resblock_layers(gen, batch, window, "window", runs=5, reps=3, warmup=1, stages=stages)
    total = {key: sum(r[key] for r in rows) for key in ("ms", "plain_ms")}
    total["bound_ms"] = sum(r["bound"][0] for r in rows)
    shapes = sorted({(r["C"], r["T"]) for r in rows}, reverse=True)
    return {"max_abs_err": worst, "shapes": [{"B": batch, "T": T, "C": C} for C, T in shapes], **total}


_CHILDREN = []  # the subprocesses this process started: stopped on the way out, whatever failed


@atexit.register
def _stop_children():
    for proc in _CHILDREN:
        if proc.poll() is None:
            _stop(proc)


def _start_daemon(*args):
    """``python -m msmctts_tpu_torch.serve *args`` (or ``python *args``
    where the first is ``-c``) as a subprocess: -> (process, queue of its
    output lines, its start on the host clock). A phase starts it before
    work that it does not time, so that the daemon's start overlaps it;
    ``_arrival`` gives the host clock at which a line came."""
    import queue
    import threading

    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, *args] if args[0] == "-c" else [sys.executable, "-m", "msmctts_tpu_torch.serve", *args]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _CHILDREN.append(proc)
    lines = queue.Queue()
    lines.arrivals = {}  # id of a line -> host clock

    def read():
        for line in proc.stdout:
            lines.arrivals[id(line)] = time.perf_counter()
            lines.put(line)

    threading.Thread(target=read, daemon=True).start()
    return proc, lines, t0


def _arrival(lines, line):
    """The host clock at which ``line`` (as ``_wait_for_line`` returned it) came."""
    return lines.arrivals[id(line)]


def _stop(proc, wait_s=30):
    proc.terminate()
    try:
        proc.wait(wait_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(30)


def _wait_for_line(lines, prefix, proc, timeout, tag="[13]"):
    """The first line of the daemon's output that starts with ``prefix``."""
    import queue

    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        try:
            line = lines.get(timeout=1.0)
        except queue.Empty:
            if proc.poll() is not None:
                raise AssertionError(f"the serving daemon exited with {proc.returncode} before '{prefix}'")
            continue
        log(f"{tag} daemon: {line.rstrip()}")
        if line.startswith(prefix):
            return line
    raise AssertionError(f"the serving daemon printed no '{prefix}' within {timeout:.0f}s")


def _http(port, method, path, body=None, timeout=SERVE_TIMEOUT_S):
    """-> (status, body bytes, seconds to the response's headers, total seconds)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        t0 = time.perf_counter()
        conn.request(method, path, body=json.dumps(body) if body is not None else None,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        t_head = time.perf_counter() - t0
        data = resp.read()
        return resp.status, data, t_head, time.perf_counter() - t0
    finally:
        conn.close()


def _pcm(data, stream):
    """int16 samples of a WAV body: a streamed one has the daemon's 44-byte
    header of unknown length."""
    import io

    from scipy.io import wavfile

    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise AssertionError(f"not a WAV body: {data[:16]!r}")
    return np.frombuffer(data[44:], "<i2") if stream else wavfile.read(io.BytesIO(data))[1]


def phase_serving(card, am_path, with_profile=False):
    import threading

    from msmctts_tpu_torch.ops import cuda_build
    from msmctts_tpu_torch.serving import BatchingEngine

    gen = torch.Generator(device="cuda").manual_seed(13)
    task = _load_tts_task(am_path, "cuda")
    n_symbols = list(task.networks["predictor"].n_symbols)
    ratio = task.networks["autoencoder"].frameshift_ratio
    eng = BatchingEngine(task, sample_rate=task.samplerate, batch_size=SERVE_B, window_ms=0.0,
                         max_frames=SERVE_MAX_FRAMES, stream_chunk_frames=SERVE_CHUNK)
    torch.cuda.synchronize()
    warm_s = eng.warmup()
    frame_buckets = eng._reachable_frame_buckets()
    log(f"[13] in-process warmup on {card}: {warm_s:.3f}s, {len(task.shapes)} shapes "
        f"(text length {eng.text_length} x frame buckets {frame_buckets}, frame margin {task.frame_margin}, "
        f"streaming {eng._streaming_warm})")
    if len(frame_buckets) != 6 or not eng._streaming_warm:
        raise AssertionError(f"warmup: frame buckets {frame_buckets}, streaming warm {eng._streaming_warm}")

    # (a) one streamed batch of 4 at chunk 64, forced durations of 4-6 frames a phone:
    # the longest utterance spans at least 4 chunks
    rng = np.random.default_rng(13)
    n_phones = [64, 57, 40, 33]
    Lt = eng.text_length  # the batch as the engine pads it
    text = _text(rng, n_phones, n_symbols, Lt)
    dur = rng.integers(4, 7, size=(SERVE_B, Lt)).astype(np.float32) * (np.arange(Lt)[None] < np.array(n_phones)[:, None])
    batch = {"text": text, "text_length": np.array(n_phones), "dur": dur}
    shapes_before = set(task.shapes)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    meta, chunks = task.predict_stream(batch, chunk_frames=SERVE_CHUNK)
    pieces, first_ms = [], None
    for c in chunks:
        pieces.append(c)
        if first_ms is None:
            first_ms = (time.perf_counter() - t0) * 1e3  # the chunk is on the host: the device has finished it
    stream_ms = (time.perf_counter() - t0) * 1e3
    counts = _counts()
    streamed = np.concatenate(pieces, axis=1)
    sd = task._streaming_decoder(SERVE_CHUNK)
    F = int(task._predict_phase1(batch)["max_frames"])
    n_windows = len(pieces)
    if n_windows < 4 or F <= sd.window_frames:
        raise AssertionError(f"streamed batch: {n_windows} chunks of a {F}-frame bucket, window {sd.window_frames}")
    want_counts = {"vq_nearest": 4, "vq_nearest_stats": 0, "fused_resblock_layer": 36 * n_windows}
    if counts != want_counts:
        raise AssertionError(f"streamed batch: launches {counts}, expected {want_counts}")
    if set(task.shapes) != shapes_before:
        raise AssertionError(f"streamed batch ran shapes the warmup did not: {set(task.shapes) - shapes_before}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mono = task.predict(batch)
    torch.cuda.synchronize()
    mono_ms = (time.perf_counter() - t0) * 1e3
    _check_wavs(mono["wav"], mono["mel_length"], ratio, "predict of the streamed batch")
    diffs = []
    for i, w in enumerate(mono["wav"]):
        if int(meta["wav_length"][i]) != w.shape[0]:
            raise AssertionError(f"stream row {i}: {meta['wav_length'][i]} samples, predict {w.shape[0]}")
        diffs.append(float(np.abs(streamed[i, : w.shape[0]] - w).max()))
    bit_equal = all(np.array_equal(streamed[i, : w.shape[0]], w) for i, w in enumerate(mono["wav"]))
    log(f"[13] streamed batch B={SERVE_B} phones {n_phones} (text bucket {Lt}, frame bucket {F}, frames "
        f"{meta['mel_length'].tolist()}): {n_windows} windows of {sd.window_frames} frames (R = {sd.context_frames}), "
        f"launches {counts}; stream vs monolithic predict on the card: max abs diff {max(diffs):.3g}, bit-equal {bit_equal}")
    if max(diffs) > AS_TOL:
        raise AssertionError(f"stream differs from predict by {max(diffs)}")
    log(f"[13] streamed batch on {card}: first chunk {first_ms:.1f} ms, whole stream {stream_ms:.1f} ms, "
        f"monolithic predict {mono_ms:.1f} ms (host clock)")

    # the kernels against their plain versions at this path's shapes
    from msmctts_tpu_torch.ops import vq

    snap_err, snap_flips = 0.0, 0
    for N in (SERVE_B * F // 4, SERVE_B * F):
        x, e = _vq_case(gen, N)
        idx, quant = vq.vq_nearest(x, e)
        ref_idx, ref_quant = vq.vq_nearest_plain(x, e)
        err, flips = _hold_snap(f"vq serving N={N}", x, e, idx, quant, ref_idx, ref_quant)
        snap_err, snap_flips = max(snap_err, err), snap_flips + flips
    window = _hold_window_layers(gen, sd.window_frames, SERVE_B)
    log(f"[13] kernels at the serving shapes: vq_nearest N={SERVE_B * F // 4} and {SERVE_B * F}: max abs err {snap_err}, "
        f"mismatches {snap_flips}; fused_resblock_layer at the window's 36 layers "
        f"{[(s['C'], s['T']) for s in window['shapes']]}: max abs err {window['max_abs_err']:.3g}, per window decode "
        f"{window['ms']:.3f} ms kernel, {window['plain_ms']:.3f} ms plain, bound {window['bound_ms']:.3f} ms")

    profile = None
    if with_profile:
        profile = profile_call(lambda: [None for _ in task.predict_stream(batch, chunk_frames=SERVE_CHUNK)[1]],
                               "[13]", "streamed batch")

    # (b)'s daemon starts here: its start overlaps the CPU check and the in-process references
    proc, lines, t_start = _start_daemon("-m", am_path, "--port", "0", "--batch-size", str(SERVE_B), "--max-frames",
                                         str(SERVE_MAX_FRAMES))

    # the same stream on the CPU (the longest row alone)
    one = {k: v[:1] for k, v in batch.items()}
    card_one = np.concatenate(list(task.predict_stream(one, chunk_frames=SERVE_CHUNK)[1]), axis=1)
    cpu = _load_tts_task(am_path, "cpu")
    cpu.max_frames_cap = SERVE_MAX_FRAMES
    t0 = time.perf_counter()
    cpu_one = np.concatenate(list(cpu.predict_stream(one, chunk_frames=SERVE_CHUNK)[1]), axis=1)
    cpu_s = time.perf_counter() - t0
    del cpu
    cpu_err = float(np.abs(card_one - cpu_one).max()) if card_one.shape == cpu_one.shape else float("inf")
    log(f"[13] stream of {n_phones[0]} phones ({card_one.shape[1]} samples), card vs CPU: max abs err {cpu_err:.3g} "
        f"(CPU {cpu_s:.1f}s)")
    if cpu_err > AS_TOL:
        raise AssertionError(f"stream on the card vs the CPU: {card_one.shape} vs {cpu_one.shape}, err {cpu_err}")

    # (b) the daemon as a subprocess under 8 concurrent clients
    texts = [_phone_string(_text(rng, [int(n)], n_symbols, int(n))[0]) for n in rng.integers(SERVE_PHONES[0], SERVE_PHONES[1] + 1, 12)]
    requests = [(t, False) for t in texts] + [(t, True) for t in texts[:SERVE_REQUESTS // 4]]
    rng.shuffle(requests)
    eng.start()
    try:
        alone = {t: eng.synthesize(t, timeout=SERVE_TIMEOUT_S) for t in texts}
    finally:
        eng.stop()
    builds_before = cuda_build.build_count()
    try:
        warm_line = _wait_for_line(lines, "warmup:", proc, SERVE_TIMEOUT_S)
        daemon_warm_s = float(warm_line.split(" in ")[1].split("s ")[0])
        if not warm_line.rstrip().endswith("kernel builds 0)"):  # phase 2 built every library
            raise AssertionError(f"the daemon built kernels at startup: {warm_line.rstrip()}")
        if f"frame margin {task.frame_margin}," not in warm_line:  # as the in-process engine's
            raise AssertionError(f"the daemon's frame margin is not {task.frame_margin}: {warm_line.rstrip()}")
        serving_line = _wait_for_line(lines, "serving on", proc, 60)
        port = int(serving_line.rsplit(":", 1)[1])
        status, data, _, _ = _http(port, "GET", "/healthz")
        if status != 200:
            raise AssertionError(f"/healthz {status}: {data[:200]!r}")
        ready_s = _arrival(lines, serving_line) - t_start
        waves = []
        for wave in (1, 2):  # the second wave: the same requests on a server that has served
            results = [None] * len(requests)

            def client(worker):
                for i in range(worker, len(requests), SERVE_CLIENTS):
                    t, stream = requests[i]
                    results[i] = _http(port, "POST", "/synthesize", {"text": t, "stream": stream})

            threads = [threading.Thread(target=client, args=(w,)) for w in range(SERVE_CLIENTS)]
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(SERVE_TIMEOUT_S)
            load_s = time.perf_counter() - t0
            if any(th.is_alive() for th in threads) or any(r is None for r in results):
                raise AssertionError(f"wave {wave} of the serving load did not finish")
            status, data, _, _ = _http(port, "GET", "/stats")
            waves.append({"results": results, "load_s": load_s, "stats": json.loads(data)})
        if proc.poll() is not None:
            raise AssertionError(f"the serving daemon died with {proc.returncode}")
    finally:
        _stop(proc)
    worst, stream_lsb = 0.0, 0
    for wave, w in enumerate(waves, 1):
        blocking_pcm = {}
        for (t, stream), (status, data, _, _) in zip(requests, w["results"]):
            if status != 200:
                raise AssertionError(f"wave {wave}, {len(t.split())} phones (stream {stream}): {status} {data[:300]!r}")
            pcm = _pcm(data, stream)
            want = alone[t]
            if pcm.shape != want.shape:
                raise AssertionError(f"wave {wave}: response of {pcm.shape} samples, in-process {want.shape} (stream {stream})")
            worst = max(worst, float(np.abs(pcm / 32767.0 - want).max()))
            if not stream:
                blocking_pcm[t] = pcm
        for (t, stream), (_, data, _, _) in zip(requests, w["results"]):
            if stream:
                lsb = np.abs(_pcm(data, True).astype(np.int32) - blocking_pcm[t].astype(np.int32)).max()
                stream_lsb = max(stream_lsb, int(lsb))
        stats = w["stats"]
        if stats["cold_shapes"] != 0 or stats["kernel_builds"] != 0 or stats["errors"] != 0 or not stats["mean_batch_size"] > 1:
            raise AssertionError(f"daemon /stats after wave {wave}: {stats}")
        lat = sorted(r[3] for (_, s), r in zip(requests, w["results"]) if not s)
        first = sorted(r[2] for (_, s), r in zip(requests, w["results"]) if s)
        w.update(p50=statistics.median(lat), p95=lat[min(len(lat) - 1, int(0.95 * len(lat)))], first=first)
        del w["results"]
        log(f"[13] daemon on {card}, wave {wave}: {len(requests)} requests ({len(first)} streamed) from {SERVE_CLIENTS} "
            f"clients in {w['load_s']:.2f}s: blocking latency p50 {w['p50'] * 1e3:.1f} ms, p95 {w['p95'] * 1e3:.1f} ms "
            f"(client clock; engine's p50 / p95 so far {stats['latency_s']['p50'] * 1e3:.1f} / "
            f"{stats['latency_s']['p95'] * 1e3:.1f} ms); streamed first chunk {[round(f * 1e3, 1) for f in first]} ms; "
            f"{stats['batches']} batches so far, mean size {stats['mean_batch_size']:.2f}, task real-time factor "
            f"{stats['task_realtime_factor']}")
    if worst > AS_TOL or stream_lsb > 1:
        raise AssertionError(f"served audio vs in-process: {worst}; streamed vs blocking PCM: {stream_lsb} LSB")
    if cuda_build.build_count() != builds_before:
        raise AssertionError("this process built a kernel during the serving phase")
    log(f"[13] daemon ready in {ready_s:.1f}s (the CPU check and the in-process references ran meanwhile; warmup "
        f"{daemon_warm_s:.3f}s); served vs in-process max abs err {worst:.3g}, "
        f"streamed vs blocking PCM at most {stream_lsb} LSB; /stats {json.dumps(stats)}")
    p50, p95, first, load_s = waves[0]["p50"], waves[0]["p95"], waves[0]["first"], waves[0]["load_s"]
    return {
        "warmup_s": warm_s, "shapes": len(task.shapes), "frame_buckets": frame_buckets,
        "stream": {"phones": n_phones, "frame_bucket": F, "frames": meta["mel_length"].tolist(), "windows": n_windows,
                   "window_frames": sd.window_frames, "context_frames": sd.context_frames, "launches": counts,
                   "max_abs_diff_vs_predict": max(diffs), "bit_equal": bit_equal, "first_chunk_ms": first_ms,
                   "stream_ms": stream_ms, "predict_ms": mono_ms, "cpu_err": cpu_err, "cpu_s": cpu_s},
        "snap": {"N": [SERVE_B * F // 4, SERVE_B * F], "max_abs_err": snap_err, "mismatches": snap_flips},
        "window": window, "profile": profile,
        "daemon": {"ready_s": ready_s, "warmup_s": daemon_warm_s, "load_s": load_s, "requests": len(requests),
                   "streamed": len(first), "latency_p50_ms": p50 * 1e3, "latency_p95_ms": p95 * 1e3,
                   "first_chunk_ms": [f * 1e3 for f in first], "served_err": worst, "stream_lsb": stream_lsb,
                   "stats": stats, "waves": waves},
    }


# ------------------------------------------------------------- QS-TTS
# Phase 14: the QS-TTS family at the full width of its two recipes (seeded
# weights and data: the repository holds no QS-TTS checkpoint or corpus).
SYN_YAML = os.path.join(ROOT, "examples", "qs-tts", "configs", "synthesizer", "msmc_vq_gan_hubertch_aishell3.yaml")
PRED_YAML = os.path.join(ROOT, "examples", "qs-tts", "configs", "predictor", "msmc_vq_gan_hubertch_tts.yaml")
QS_B, QS_FRAMES, QS_LENGTHS = 4, 512, (512, 437, 350, 268)  # analysis-synthesis: 6.4 s rows at 16 kHz, bucket 512
QS_STAGES = [(256, 5), (128, 5), (64, 4), (32, 2)]  # the x200 generator: T = 5F / 25F / 100F / 200F
QS_TRAIN_B, QS_TRAIN_FRAMES, QS_TRAIN_LENGTHS = 16, 384, (200, 380)
QS_STEPS = 4  # supervised (1), decode (2), GAN (3, 4) with frame / stft supervised steps 1 / 2
QS_PHASES = {1: "supervised", 2: "decode", 3: "gan", 4: "gan"}


def _qs_emb_batch(rng, lengths, T, emb_dim=1024, n_mel=80, hop=200):
    """Seeded emb / mel / wav padded as ``EmbDataset`` pads them (emb 0, mel -4, wav 0)."""
    lengths = np.asarray(lengths, np.int32)
    valid = np.arange(T)[None, :] < lengths[:, None]
    emb = np.where(valid[..., None], rng.normal(size=(len(lengths), T, emb_dim)), 0.0).astype(np.float32)
    mel = np.where(valid[..., None], rng.normal(size=(len(lengths), T, n_mel)) * 0.5, -4.0).astype(np.float32)
    wav = (rng.normal(size=(len(lengths), T * hop)) * 0.1 * np.repeat(valid, hop, axis=1)).astype(np.float32)
    return {"emb": emb, "emb_length": lengths, "mel": mel, "wav": wav}


def _qs_syn_config(save_dir, small=False):
    """The synthesizer recipe, frame / stft supervised steps 1 / 2 so that
    four steps cross the three phases. ``small``: the card-vs-CPU check's
    config, which turns on what the recipe leaves off (ECAPA global encoder,
    pitch / energy, the prosody estimator), with dropout 0 and short windows."""
    from msmctts_tpu_torch.config import Config

    cfg = Config(SYN_YAML)
    cfg.trainer["frame_loss_supervised_step"] = 1
    cfg.trainer["stft_loss_supervised_step"] = 2
    cfg["save_checkpoint_dir"] = save_dir
    if small:
        ae = cfg.task["autoencoder"]
        ae["pitch_dim"] = ae["energy_dim"] = 1
        ae["global_encoder_config"] = {"_name": "ECAPA_TDNN"}
        for node in (ae["encoder_config"], ae["frame_decoder_config"]):
            node["dropout"] = node["attn_dropout"] = 0.0
        ae["quantizer_config"]["dropout"] = 0.0
        ae["quantizer_config"]["prior_config"]["p_dropout"] = 0.0
        cfg.task["prosody_estimator"] = {"_name": "AttrPredictor", "in_channels": ae["n_model_size"], "out_channels": 2}
        cfg.trainer["sample_batch_size"] = 2
        cfg.trainer["sample_lengths"] = 3200
    return cfg


def _qs_trainer(cfg, device, seed=1234):
    from msmctts_tpu_torch.config import component_kwargs
    from msmctts_tpu_torch.registry import get_trainer
    from msmctts_tpu_torch.tasks import build_task

    cfg["seed"] = seed
    task = build_task(cfg, device=device, mode="train")
    trainer = get_trainer(cfg.trainer["_name"])(cfg, task, **component_kwargs(cfg.trainer))
    trainer.init_state()
    return trainer


def _snap_rows(ae, run):
    """Run ``run()`` and return, per quantizer stage, (x [N, H, d], embed, idx)."""
    snaps = []
    pre = [q.register_forward_pre_hook(lambda m, a: snaps.append({"x": a[0].detach().reshape(-1, m.n_head, m.sub_dim)}))
           for q in ae.quantizer.quantizer]
    post = [q.register_forward_hook(lambda m, a, o: snaps[-1].update(idx=o[2].reshape(-1, m.n_head), embed=m.embed))
            for q in ae.quantizer.quantizer]
    try:
        run()
    finally:
        for h in pre + post:
            h.remove()
    return snaps


def _hold_snaps(snaps, what, tag="[14]"):
    """The snap kernel against its plain version at each stage's N, with
    device, event and plain times and the bound."""
    from msmctts_tpu_torch.ops import vq

    rows = []
    for stage, s in enumerate(snaps):
        x, e = s["x"].contiguous(), s["embed"]
        idx, quant = vq.vq_nearest(x, e)
        ref_idx, ref_quant = vq.vq_nearest_plain(x, e)
        torch.cuda.synchronize()
        if not torch.equal(idx, s["idx"].to(idx.dtype)):
            raise AssertionError(f"{what} stage {stage}: the path's indices differ from a second launch")
        err, mismatches = _hold_snap(f"{what} stage {stage}", x, e, idx, quant, ref_idx, ref_quant)
        b = _snap_bound(x.shape[0])
        rows.append({"stage": stage, "N": x.shape[0], "index_mismatches": mismatches, "max_abs_err": err,
                     "device_ms": device_profile(lambda: vq.vq_nearest(x, e))["ms"],
                     "ms": time_ms(lambda: vq.vq_nearest(x, e), runs=20),
                     "plain_ms": time_ms(lambda: vq.vq_nearest_plain(x, e), runs=20), "bound_ms": b[0], "bound_by": b[1]})
        log(f"{tag} {what} snap stage {stage}: {json.dumps(rows[-1])}")
    return rows


def _stats_rows(ae, run):
    """Run ``run()`` (one train step) and return, per quantizer stage, the
    statistics kernel's inputs as the path gave them (x [N, H, d], the
    codebook before its update, mask [N]) and the indices the path got."""
    from msmctts_tpu_torch.ops.masking import sequence_mask

    rows = []

    def pre(m, args, kwargs):
        x = args[0]
        B, T, _ = x.shape
        lengths = kwargs.get("lengths", args[1] if len(args) > 1 else None)
        mask = (torch.ones(B * T, device=x.device) if lengths is None
                else sequence_mask(lengths, T, dtype=torch.float32).reshape(B * T))
        rows.append({"x": x.detach().float().reshape(B * T, m.n_head, m.sub_dim).clone(), "embed": m.embed.clone(),
                     "mask": mask})

    pre_h = [q.register_forward_pre_hook(pre, with_kwargs=True) for q in ae.quantizer.quantizer]
    post_h = [q.register_forward_hook(lambda m, a, o: rows[-1].update(idx=o[2].reshape(-1, m.n_head)))
              for q in ae.quantizer.quantizer]
    try:
        run()
    finally:
        for h in pre_h + post_h:
            h.remove()
    return rows


def _assignment_stats(x, mask, idx, K):
    """Plain masked counts [H, K] and sums [H, d, K] of a given assignment."""
    onehot = torch.nn.functional.one_hot(idx.long(), K).to(x.dtype) * mask[:, None, None]
    return onehot.sum(0), torch.einsum("nhd,nhk->hdk", x, onehot)


def _hold_stats(rows, what, tag="[14]", timed=True, ties=False):
    """The statistics kernel against its plain version on each stage's inputs
    from the path, as phase 3 holds it: idx, quant and counts exact, sums
    within ``VQS_TOL``; with device, event and plain times (unless not
    ``timed``: ranks time-slicing one card) and the bound. With ``ties`` an
    index may differ from the plain search's between codewords at equal
    distance (``VQ_TOL``, as the snaps' holds allow); the statistics are
    then held against the plain statistics of the kernel's assignment."""
    from msmctts_tpu_torch.ops import vq

    out = []
    for stage, r in enumerate(rows):
        x, e, mask = r["x"], r["embed"], r["mask"]
        N, valid = x.shape[0], int(mask.sum())
        if tuple(e.shape) != (VQ_H, VQ_D, VQ_K):
            raise AssertionError(f"{what} stage {stage}: codebook {tuple(e.shape)}, the bound assumes {(VQ_H, VQ_D, VQ_K)}")
        idx, quant, counts, sums = vq.vq_nearest_stats(x, e, mask)
        p_idx, p_quant, p_counts, p_sums = vq.vq_nearest_stats_plain(x, e, mask)
        torch.cuda.synchronize()
        if not torch.equal(idx, r["idx"].to(idx.dtype)):
            raise AssertionError(f"{what} stage {stage}: the path's indices differ from a second launch")
        n_ties = 0
        if ties and not torch.equal(idx, p_idx):
            _, n_ties = _hold_snap(f"{what} stage {stage}", x, e, idx, quant, p_idx, p_quant)
            p_counts, p_sums = _assignment_stats(x, mask, idx, e.shape[-1])
        elif not (torch.equal(idx, p_idx) and torch.equal(quant, p_quant)):
            raise AssertionError(f"{what} stage {stage}: idx/quant differ from the plain version "
                                 f"({int((idx != p_idx).sum())} indices)")
        if not torch.equal(counts, p_counts) or float(counts.sum()) != valid * VQ_H:
            raise AssertionError(f"{what} stage {stage}: counts differ from the plain version or the valid rows")
        err = float((sums - p_sums).abs().max())
        if not torch.allclose(sums, p_sums, **VQS_TOL):
            raise AssertionError(f"{what} stage {stage}: sums differ by {err}")
        b = _stats_bound(N, valid)
        out.append({"stage": stage, "N": N, "valid": valid, "walkers": vq.stats_plan(N, VQ_D, VQ_K).walkers,
                    "sums_max_abs_err": err, "bound_ms": b[0], "bound_by": b[1]})
        if ties:
            out[-1]["index_ties"] = n_ties
        if timed:
            out[-1].update(device_ms=device_profile(lambda: vq.vq_nearest_stats(x, e, mask))["ms"],
                           ms=time_ms(lambda: vq.vq_nearest_stats(x, e, mask), runs=20),
                           plain_ms=time_ms(lambda: vq.vq_nearest_stats_plain(x, e, mask), runs=20))
        log(f"{tag} {what} statistics stage {stage}: {json.dumps(out[-1])}")
    return out


def _audible(module, seed):
    """Weight-norm gains drawn from U(0.5, 1.5): a seeded HiFi-GAN whose
    kernels keep their N(0, 0.01) directions decodes to ~1e-4, where a
    card-vs-CPU difference in absolute terms says nothing; with unit-scale
    kernels the waveform is O(0.1)."""
    from msmctts_tpu_torch.ops.convs import refold

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("weight_g"):
                p.copy_((torch.rand(p.shape, generator=gen) + 0.5).to(p.device))
    refold(module)


def phase_qs_analysis_synthesis(gen, card, with_profile=False):
    """(a) The synthesizer recipe's analysis-synthesis on seeded weights."""
    from msmctts_tpu_torch.config import Config
    from msmctts_tpu_torch.tasks import build_task
    from msmctts_tpu_torch.weights import init_random, load_numpy_state, state_dict_numpy

    cfg = Config(SYN_YAML)
    task = build_task(cfg, device="cuda")
    ae = task.networks["autoencoder"]
    init_random(ae, 1234)
    _audible(ae.decoder, 1234)
    ae.eval()
    ratio, sr = ae.frameshift_ratio, task.samplerate
    n_params = sum(p.numel() for p in ae.parameters())
    rng = np.random.default_rng(14)

    # small input: the card against the same weights on the CPU
    cpu = build_task(cfg, device="cpu")
    load_numpy_state(cpu.networks["autoencoder"], state_dict_numpy(ae))
    small = _qs_emb_batch(rng, [64], 64)
    small = {k: small[k] for k in ("emb", "emb_length")}
    got, want = task.analysis_synthesis(small), cpu.analysis_synthesis(small)
    err = float(np.abs(got["wav"][0] - want["wav"][0]).max())
    with torch.inference_mode():
        gi = ae.analysis(torch.as_tensor(small["emb"], device="cuda"), torch.tensor([64], device="cuda"))
        ci = cpu.networks["autoencoder"].analysis(torch.as_tensor(small["emb"]), torch.tensor([64]))
    idx_equal = all(torch.equal(a.cpu(), b) for a, b in zip(gi["quantizer_indices"], ci["quantizer_indices"]))
    log(f"[14] QS-TTS synthesizer {n_params / 1e6:.1f}M parameters (seeded); analysis-synthesis T=64, card vs CPU: "
        f"indices equal {idx_equal}, wav max abs err {err:.3g} (|wav| max {np.abs(want['wav'][0]).max():.3g})")
    if err > AS_TOL or not idx_equal:
        raise AssertionError(f"QS-TTS analysis-synthesis disagrees with the CPU: err {err}, indices equal {idx_equal}")
    del cpu

    batch = _qs_emb_batch(rng, QS_LENGTHS, QS_FRAMES)
    batch = {k: batch[k] for k in ("emb", "emb_length")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    task.analysis_synthesis(batch)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    _reset_counts()
    out = task.analysis_synthesis(batch)
    torch.cuda.synchronize()
    counts = _counts()
    for w, n in zip(out["wav"], QS_LENGTHS):
        if w.shape != (n * ratio,) or not np.isfinite(w).all() or not np.abs(w).max() > 0:
            raise AssertionError(f"QS-TTS analysis-synthesis: wav {w.shape} for {n} frames, finite {np.isfinite(w).all()}")
    log(f"[14] analysis-synthesis B={QS_B} frames {list(QS_LENGTHS)} (bucket {QS_FRAMES}): launches {counts}, "
        f"|wav| max {max(float(np.abs(w).max()) for w in out['wav']):.3g}")
    if counts != {"vq_nearest": 2, "vq_nearest_stats": 0, "fused_resblock_layer": 36}:
        raise AssertionError(f"QS-TTS analysis-synthesis launches {counts}, expected 2 VQ and 36 resblock")
    warm = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        task.analysis_synthesis(batch)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
    warm_ms = statistics.median(warm)
    audio_s = sum(QS_LENGTHS) * ratio / sr
    log(f"[14] analysis-synthesis per batch on {card}: first {first_ms:.1f} ms, warm median {warm_ms:.1f} ms "
        f"(runs {[round(w, 1) for w in warm]}), {audio_s:.2f} s of audio, {audio_s / warm_ms * 1e3:.1f}x real time")
    profile = profile_call(lambda: task.analysis_synthesis(batch), "[14]", "analysis-synthesis") if with_profile else None

    # kernels 1 and 5 at this path's shapes, against their plain versions
    snaps = _snap_rows(ae, lambda: task.analysis_synthesis(batch))
    snap_rows = _hold_snaps(snaps, "analysis-synthesis")
    rows, worst = _resblock_layers(gen, QS_B, QS_FRAMES, "qs-tts decode", library=True, stages=QS_STAGES)
    keys = ("ms", "plain_ms", "library_ms", "bound_fp32_ms")
    rb_total = {key: sum(r[key] for r in rows) for key in keys}
    rb_total["bound_ms"] = sum(r["bound"][0] for r in rows)
    rb_total["max_abs_err"] = worst
    rb_total["shapes"] = sorted({(r["C"], r["T"]) for r in rows}, reverse=True)
    log(f"[14] resblock, all 36 layers of one x200 decode (B={QS_B}, {QS_FRAMES} frames): {json.dumps(rb_total)}")
    return {"params": n_params, "cpu_wav_err": err, "launches": counts, "first_ms": first_ms, "warm_ms": warm_ms,
            "warm_runs_ms": warm, "audio_s": audio_s, "rtf_x": audio_s / warm_ms * 1e3, "snap": snap_rows,
            "resblock": rb_total, "resblock_rows": rows, "profile": profile}


def phase_qs_training(card, with_profile=False):
    """(b) ``EmbVQGANTrainer`` at the synthesizer recipe's width, batch 16,
    through its three phases; the trained synthesizer saved as a checkpoint."""
    from msmctts_tpu_torch.data.loader import to_device
    from msmctts_tpu_torch.training.base_trainer import metrics_to_host

    torch.cuda.empty_cache()
    base_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    trainer = _qs_trainer(_qs_syn_config(os.path.join(SMOKE_DIR, "ckpt_qs_syn")), "cuda")
    ae, disc = trainer.ae, trainer.disc
    rng = np.random.default_rng(15)
    lengths = rng.integers(QS_TRAIN_LENGTHS[0], QS_TRAIN_LENGTHS[1] + 1, size=QS_TRAIN_B)
    lengths[0] = QS_TRAIN_LENGTHS[1]
    batch = to_device(_qs_emb_batch(rng, lengths, QS_TRAIN_FRAMES), "cuda")
    log(f"[14] QS-TTS synthesizer training: {sum(p.numel() for p in ae.parameters()) / 1e6:.1f}M + discriminator "
        f"{sum(p.numel() for p in disc.parameters()) / 1e6:.1f}M parameters; batch {QS_TRAIN_B}, frames "
        f"{lengths.min()}-{lengths.max()} (bucket {QS_TRAIN_FRAMES}), {trainer.sample_batch_size} windows of "
        f"{trainer.sample_lengths} samples")
    steps = []
    for it in range(1, QS_STEPS + 1):
        ae_before = [p.detach().clone() for p in ae.parameters()]
        d_before = [p.detach().clone() for p in disc.parameters()]
        cb_before = [q.embed.clone() for q in ae.quantizer.quantizer]
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch, it)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = _counts()
        host = metrics_to_host(metrics)
        bad = [k for k, v in host.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"QS-TTS train step {it}: non-finite metrics {bad}")
        if counts != {"vq_nearest": 0, "vq_nearest_stats": 2, "fused_resblock_layer": 0}:
            raise AssertionError(f"QS-TTS train step {it}: launches {counts}, expected 2 vq_nearest_stats only")
        phase = QS_PHASES[it]
        ae_moved, d_moved = _moved(ae, ae_before), _moved(disc, d_before)
        dec_moved = _moved(ae.decoder, [b for (n, _), b in zip(ae.named_parameters(), ae_before) if n.startswith("decoder.")])
        cb_moved = sum(int(not torch.equal(q.embed, b)) for q, b in zip(ae.quantizer.quantizer, cb_before))
        # the decoder runs from the decode phase on; at a seeded init its waveform can sit below the log-mel
        # loss's clamp (no gradient there), so only the GAN phase's adversarial terms must move it
        if (ae_moved == 0 or (phase == "gan") != (d_moved > 0) or (phase == "supervised" and dec_moved)
                or (phase == "gan" and not dec_moved) or cb_moved != 2):
            raise AssertionError(f"QS-TTS step {it} ({phase}): moved ae {ae_moved} (decoder {dec_moved}), "
                                 f"discriminator {d_moved}, codebooks {cb_moved}")
        steps.append({"iteration": it, "phase": phase, "ms": ms, "launches": counts, "metrics": host,
                      "ae_tensors_moved": ae_moved, "decoder_tensors_moved": dec_moved, "d_tensors_moved": d_moved})
        shown = {k: round(host[k], 4) for k in ("g_loss", "vq_loss", "frame_loss", "stft_loss", "d_loss", "fm_loss") if k in host}
        log(f"[14] QS-TTS step {it} ({phase}): {ms:.1f} ms, launches {counts}, moved ae {ae_moved} (decoder "
            f"{dec_moved}) d {d_moved} codebooks {cb_moved}, {shown}")

    def timed(it):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch, it)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    warm = {phase: [timed(it) for _ in range(3)] for phase, it in (("supervised", 1), ("decode", 2), ("gan", 5))}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    # kernel 2 at this path's shapes (walkers and partials follow N), against its plain version
    stats = _stats_rows(ae, lambda: trainer.train_step(batch, QS_STEPS + 1))
    if len(stats) != 2:
        raise AssertionError(f"QS-TTS train step: {len(stats)} quantizer calls, expected 2")
    result = {"steps": steps, "warm_ms": {k: statistics.median(v) for k, v in warm.items()}, "warm_runs_ms": warm,
              "peak_memory_gib": peak_gib, "peak_above_start_gib": peak_gib - base_gib,
              "launches_per_step": steps[-1]["launches"], "stats": _hold_stats(stats, "QS-TTS train step")}
    log(f"[14] QS-TTS per train step on {card}: first {[round(st['ms'], 1) for st in steps]} ms; warm median "
        f"{json.dumps({k: round(v, 1) for k, v in result['warm_ms'].items()})} ms; peak memory {peak_gib:.2f} GiB")
    if with_profile:
        result["profile"] = profile_call(lambda: trainer.train_step(batch, 6), "[14]", "QS-TTS GAN step")
    trainer.iteration = QS_STEPS
    result["checkpoint"] = trainer.save()
    log(f"[14] trained synthesizer -> {os.path.relpath(result['checkpoint'], ROOT)}")
    return result


def _flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat_tree(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: np.asarray(v)})
    return out


def _adam_step_bound(lr, betas, t):
    """The largest move of a weight at Adam's ``t``-th step, for any
    gradients: with the bias-corrected moments m = sum(w_i g_i) and v =
    sum(u_i g_i^2), Cauchy-Schwarz gives |m| / sqrt(v) <= sqrt(sum(w_i^2 / u_i));
    lr at the first step, a little more after it."""
    b1, b2 = (float(b) for b in betas)
    w = [(1 - b1) * b1 ** (t - i) / (1 - b1 ** t) for i in range(1, t + 1)]
    u = [(1 - b2) * b2 ** (t - i) / (1 - b2 ** t) for i in range(1, t + 1)]
    return lr * math.sqrt(sum(a * a / c for a, c in zip(w, u)))


def phase_qs_step_card_vs_cpu():
    """One step of each phase from equal state on the card and on the CPU:
    the small config (ECAPA, pitch / energy, prosody estimator on), 2
    utterances, dropout 0, the same windows."""
    from msmctts_tpu_torch.data.loader import to_device
    from msmctts_tpu_torch.training.base_trainer import metrics_to_host

    rng = np.random.default_rng(16)
    batch = _qs_emb_batch(rng, [64, 48], 64)
    batch["pitch"] = (rng.normal(size=(2, 64, 1)) * (np.arange(64)[None, :, None] < batch["emb_length"][:, None, None])).astype(np.float32)
    batch["energy"] = (rng.normal(size=(2, 64, 1)) * (np.arange(64)[None, :, None] < batch["emb_length"][:, None, None])).astype(np.float32)
    windows = {2: (np.array([0, 1]), np.array([7, 20])), 3: (np.array([0, 1]), np.array([30, 2]))}
    card = _qs_trainer(_qs_syn_config(os.path.join(SMOKE_DIR, "ckpt_qs_small"), small=True), "cuda")
    cpu = _qs_trainer(_qs_syn_config(os.path.join(SMOKE_DIR, "ckpt_qs_small"), small=True), "cpu")
    # an Adam step moves a weight by up to _adam_step_bound whatever its gradient's size, so where the two
    # gradients are at rounding level the two weights may part by twice that
    opt = card.config["optimizer"]["_default"]
    param_atol = 2 * max(_adam_step_bound(float(opt["learning_rate"]), opt["betas"], t) for t in (1, 2, 3)) + 1e-6
    worst = {"loss_rel": 0.0, "codebook_abs": 0.0, "batch_stats_abs": 0.0, "param_abs": 0.0}
    far = total = 0
    same = True
    steps = {}
    for it in (1, 2, 3):
        cpu.load_state_tree(card.state_tree())  # equal state before each phase's step
        out = {}
        for name, tr in (("card", card), ("cpu", cpu)):
            idx = []
            hooks = [q.register_forward_hook(lambda m, a, o: idx.append(o[2].cpu())) for q in tr.ae.quantizer.quantizer]
            m = metrics_to_host(tr.train_step(to_device(batch, tr.device), it, windows=windows.get(it)))
            for h in hooks:
                h.remove()
            out[name] = {"metrics": m, "indices": idx, "state": tr.state_tree()}
        for k, want in out["cpu"]["metrics"].items():
            got = out["card"]["metrics"][k]
            rel = abs(got - want) / max(abs(want), 1e-3)
            worst["loss_rel"] = max(worst["loss_rel"], rel)
            if rel > STEP_TOL["loss_rtol"]:
                raise AssertionError(f"QS-TTS {QS_PHASES[it]} step, {k}: card {got} vs CPU {want}")
        same = same and all(torch.equal(a, b) for a, b in zip(out["card"]["indices"], out["cpu"]["indices"]))
        for key, tag in (("codebook", "codebook_abs"), ("model_state", "batch_stats_abs")):
            a, b = _flat_tree(out["card"]["state"][key]), _flat_tree(out["cpu"]["state"][key])
            # a codeword no frame chose holds its sum over a cluster size near 0: relative there
            worst[tag] = max(worst[tag], max(float(np.max(np.abs(a[k] - b[k]) / np.maximum(1.0, np.abs(b[k])))) for k in b))
        a, b = _flat_tree(out["card"]["state"]["params"]), _flat_tree(out["cpu"]["state"]["params"])
        if sorted(a) != sorted(b):
            raise AssertionError(f"QS-TTS {QS_PHASES[it]} step: the card's and the CPU's parameter trees differ")
        for k in b:
            gap = np.abs(a[k] - b[k])
            worst["param_abs"] = max(worst["param_abs"], float(gap.max()))
            far += int((gap > 1e-5).sum())
            total += gap.size
        steps[QS_PHASES[it]] = {k: out[k]["metrics"] for k in ("card", "cpu")}
    log(f"[14] one step of each phase from equal state, card vs CPU (ECAPA, pitch / energy, prosody estimator on; "
        f"B=2, 64 frames): indices equal {same}, worst loss rel diff {worst['loss_rel']:.3g}, codebook "
        f"{worst['codebook_abs']:.3g}, BN statistics {worst['batch_stats_abs']:.3g}, parameters after the step "
        f"{worst['param_abs']:.3g} (bound {param_atol:.3g}; {far} of {total} entries further than 1e-5 apart); "
        f"metrics {sorted(steps['gan']['cpu'])}")
    if (not same or worst["codebook_abs"] > STEP_TOL["codebook_atol"] or worst["batch_stats_abs"] > BN_STATS_RTOL
            or worst["param_abs"] > param_atol):
        raise AssertionError(f"QS-TTS train step disagrees with the CPU: indices equal {same}, {worst}")
    return {**worst, "param_atol": param_atol, "params_far": far, "params_total": total, "indices_equal": same,
            "steps": steps}


def _qs_pred_config(syn_ckpt, save_dir):
    from msmctts_tpu_torch.config import Config

    cfg = Config(PRED_YAML)
    cfg.task["autoencoder"]["_checkpoint"] = syn_ckpt
    cfg.task["autoencoder"].pop("_config", None)  # the checkpoint's embedded config
    cfg["save_checkpoint_dir"] = save_dir
    return cfg


def _qs_am_batch(rng, n_symbols, B, Lt, T, phones, frames):
    b = _am_batch(rng, n_symbols, B, Lt, T, phones, frames, n_mel=1024)
    valid = np.arange(T)[None, :] < b["mel_length"][:, None]
    emb = np.where(valid[..., None], b.pop("mel"), 0.0).astype(np.float32)
    return {**b, "emb": emb, "emb_length": b.pop("mel_length")}


def phase_qs_predictor_training(card, syn_ckpt, with_profile=False):
    """(c) ``NASynEmbFSTrainer`` at the predictor recipe's width, batch 64,
    dropout on, the synthesizer of (b) as its teacher."""
    from msmctts_tpu_torch.data.loader import to_device
    from msmctts_tpu_torch.training.base_trainer import metrics_to_host

    torch.cuda.empty_cache()
    base_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    trainer = _qs_trainer(_qs_pred_config(syn_ckpt, os.path.join(SMOKE_DIR, "ckpt_qs_pred")), "cuda")
    predictor, ae = trainer.predictor, trainer.frozen_autoencoder()
    n_symbols = list(trainer.config.task["predictor"]["n_symbols"])
    batch_np = _qs_am_batch(np.random.default_rng(17), n_symbols, AM_B, AM_TEXT, AM_FRAMES, AM_PHONES, AM_LENGTHS)
    batch = to_device(batch_np, "cuda")
    teacher0 = {k: v.clone() for k, v in ae.state_dict().items()}
    log(f"[14] QS-TTS predictor {sum(p.numel() for p in predictor.parameters()) / 1e6:.1f}M parameters, streams "
        f"{n_symbols}; batch {AM_B}, phones {batch_np['text_length'].min()}-{batch_np['text_length'].max()} (bucket "
        f"{AM_TEXT}), emb frames {batch_np['emb_length'].min()}-{batch_np['emb_length'].max()} (bucket {AM_FRAMES}), dropout on")
    steps, snaps = [], []
    for it in range(1, AM_STEPS + 1):
        before = [p.detach().clone() for p in predictor.parameters()]
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch, it)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = _counts()
        host = metrics_to_host(metrics)
        if not all(np.isfinite(v) for v in host.values()):
            raise AssertionError(f"QS-TTS predictor step {it}: non-finite metrics {host}")
        if counts != {"vq_nearest": 2, "vq_nearest_stats": 0, "fused_resblock_layer": 0}:
            raise AssertionError(f"QS-TTS predictor step {it}: launches {counts}, expected the teacher's 2 vq_nearest")
        moved = _moved(predictor, before)
        if moved < 0.9 * len(before):
            raise AssertionError(f"QS-TTS predictor step {it}: only {moved} of {len(before)} tensors moved")
        steps.append({"iteration": it, "ms": ms, "launches": counts, "metrics": host, "tensors_moved": moved})
        log(f"[14] QS-TTS predictor step {it}: {ms:.1f} ms, launches {counts}, moved {moved}/{len(before)}, "
            f"{ {k: round(v, 4) for k, v in sorted(host.items())} }")
    snaps = _snap_rows(ae, lambda: trainer.train_step(batch, AM_STEPS + 1))
    snap_rows = _hold_snaps(snaps, "QS-TTS teacher")
    changed = [k for k, v in ae.state_dict().items() if not torch.equal(v, teacher0[k])]
    if changed or ae.training:
        raise AssertionError(f"the QS-TTS teacher changed: {changed[:5]} (training mode {ae.training})")

    def timed(it):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch, it)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    warm = [timed(AM_STEPS + 2 + i) for i in range(3)]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    result = {"steps": steps, "first_ms": steps[0]["ms"], "warm_ms": statistics.median(warm), "warm_runs_ms": warm,
              "peak_memory_gib": peak_gib, "peak_above_start_gib": peak_gib - base_gib, "snap": snap_rows,
              "launches_per_step": steps[-1]["launches"]}
    log(f"[14] QS-TTS predictor per step on {card}: first {result['first_ms']:.1f} ms, warm median "
        f"{result['warm_ms']:.1f} ms (runs {[round(w, 1) for w in warm]}); peak memory {peak_gib:.2f} GiB; the "
        f"teacher's 2 snaps {sum(r['device_ms'] for r in snap_rows):.4f} ms on the device; teacher bit-equal after the steps")
    if with_profile:
        result["profile"] = profile_call(lambda: trainer.train_step(batch, 20), "[14]", "QS-TTS predictor step")
    return result


def _write_qs_corpus(d, n_symbols, n_utts=12, seed=18):
    """A small corpus of both recipes: emb/*.npy [T, 1024], mel/*.npy,
    wav/*.wav at 16 kHz, phone.txt / dur.txt books, train.list."""
    from msmctts_tpu_torch.data.datasets import save_wav

    rng = np.random.default_rng(seed)
    b = _am_batch(rng, n_symbols, n_utts, 48, 192, (12, 48), (60, 190), n_mel=80)
    for sub in ("emb", "mel", "wav"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    ids, phones, durs = [], [], []
    for i in range(n_utts):
        uid = f"qs{i:03d}"
        n, f = int(b["text_length"][i]), int(b["mel_length"][i])
        ids.append(uid)
        phones.append(uid + "|" + " ".join("_".join(str(v) for v in row) for row in b["text"][i, :n]))
        durs.append(uid + "|" + " ".join(str(int(v)) for v in b["dur"][i, :n]))
        np.save(os.path.join(d, "emb", f"{uid}.npy"), rng.normal(size=(f, 1024)).astype(np.float32))
        np.save(os.path.join(d, "mel", f"{uid}.npy"), b["mel"][i, :f])
        save_wav(os.path.join(d, "wav", f"{uid}.wav"), rng.normal(size=f * 200) * 0.1, 16000)
    for name, lines in (("train.list", ids), ("phone.txt", phones), ("dur.txt", durs)):
        with open(os.path.join(d, name), "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return ids, b["mel_length"]


def phase_qs_entry_points(card):
    """(d) Both recipes through the train entry point and the synthesizer's
    checkpoint through ``infer``, all in process (phase 18 runs ``train`` as
    a process, phases 13 and 16 the daemon and ``infer``), on a corpus
    written here."""
    import shutil

    import yaml

    from msmctts_tpu_torch.config import Config

    d = os.path.join(SMOKE_DIR, "qs_corpus")
    n_symbols = list(Config(PRED_YAML).task["predictor"]["n_symbols"])
    ids, frames = _write_qs_corpus(d, n_symbols)
    syn = Config(SYN_YAML)
    syn["save_checkpoint_dir"] = os.path.join(SMOKE_DIR, "ckpt_qs_syn_cli")
    shutil.rmtree(syn["save_checkpoint_dir"], ignore_errors=True)
    syn["dataloader"] = {"batch_size": 4, "num_workers": 2}
    syn.dataset["id_list"] = os.path.join(d, "train.list")
    syn.dataset["feature_path"] = [os.path.join(d, sub, "{}" + ext) for sub, ext in (("emb", ".npy"), ("mel", ".npy"), ("wav", ".wav"))]
    syn_path = os.path.join(SMOKE_DIR, "qs_syn_cli.yaml")
    with open(syn_path, "w") as fh:
        yaml.safe_dump(syn.to_dict(), fh)
    from msmctts_tpu_torch import train

    t0 = time.perf_counter()  # in process: phase 18 runs the CLI's own process
    train.main(["-c", syn_path, "--max-steps", "2", "--log-every", "1"])
    wall = time.perf_counter() - t0
    syn_ckpt = os.path.join(syn["save_checkpoint_dir"], "model_2")
    text = "".join(open(os.path.join(syn["save_checkpoint_dir"], f)).read()
                   for f in os.listdir(syn["save_checkpoint_dir"]) if f.endswith(".log"))
    last = [line for line in text.splitlines() if "step 2" in line]
    if not last or not os.path.exists(syn_ckpt):
        raise AssertionError(f"the synthesizer recipe's train run wrote no model_2:\n{text[-3000:]}")
    log(f"[14] train entry point, in process, synthesizer recipe, 2 steps at batch 4 ({wall:.1f}s): {last[-1].strip()}")

    test_list = os.path.join(SMOKE_DIR, "qs_test.yaml")
    with open(test_list, "w") as fh:
        yaml.safe_dump({u: {"emb": os.path.join(d, "emb", f"{u}.npy"), "mel": os.path.join(d, "mel", f"{u}.npy")}
                        for u in ids[:3]}, fh)
    out_dir = os.path.join(SMOKE_DIR, "qs_infer")
    shutil.rmtree(out_dir, ignore_errors=True)
    from scipy.io import wavfile

    from msmctts_tpu_torch import infer

    t0 = time.perf_counter()
    infer.main(["-m", syn_ckpt, "-t", test_list, "-o", out_dir])  # in process: phase 13 runs the CLI's own process
    infer_wall = time.perf_counter() - t0

    lengths = {u: wavfile.read(os.path.join(out_dir, f"{u}_wav.wav"))[1].shape[0] for u in ids[:3]}
    want = {u: int(n) * 200 for u, n in zip(ids[:3], frames[:3])}
    if lengths != want or len(set(lengths.values())) < 2:
        raise AssertionError(f"infer wrote wavs of {lengths} samples, expected {want}, distinct")
    log(f"[14] infer entry point, in process ({infer_wall:.1f}s): wav samples {lengths}")

    pred = _qs_pred_config(syn_ckpt, os.path.join(SMOKE_DIR, "ckpt_qs_pred_cli"))
    shutil.rmtree(pred["save_checkpoint_dir"], ignore_errors=True)
    pred["dataloader"] = {"batch_size": 8, "num_workers": 2}
    pred.dataset["id_list"] = os.path.join(d, "train.list")
    pred.dataset["feature_path"] = [os.path.join(d, "phone.txt"), os.path.join(d, "dur.txt"), os.path.join(d, "emb", "{}.npy")]
    pred_path = os.path.join(SMOKE_DIR, "qs_pred_cli.yaml")
    with open(pred_path, "w") as fh:
        yaml.safe_dump(pred.to_dict(), fh)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    trainer = train.main(["-c", pred_path, "--max-steps", "2", "--log-every", "1"])
    torch.cuda.synchronize()
    pred_wall = time.perf_counter() - t0
    pred_counts = _counts()
    del trainer
    torch.cuda.empty_cache()
    text_p = "".join(open(os.path.join(pred["save_checkpoint_dir"], f)).read()
                     for f in os.listdir(pred["save_checkpoint_dir"]) if f.endswith(".log"))
    last_p = [line for line in text_p.splitlines() if "step 2" in line]
    if not last_p or not os.path.exists(os.path.join(pred["save_checkpoint_dir"], "model_2")):
        raise AssertionError(f"the predictor recipe's train run wrote no model_2:\n{text_p[-3000:]}")
    if pred_counts != {"vq_nearest": 4, "vq_nearest_stats": 0, "fused_resblock_layer": 0}:
        raise AssertionError(f"2 QS predictor steps through train(): launches {pred_counts}, expected the teacher's 2 "
                             f"snaps a step")
    log(f"[14] train entry point, in process, predictor recipe against that checkpoint, 2 steps at batch 8 "
        f"({pred_wall:.1f}s; launches {pred_counts}): {last_p[-1].strip()}")
    return {"train_wall_s": wall, "infer_wall_s": infer_wall, "predictor_train_wall_s": pred_wall,
            "predictor_train_launches": pred_counts, "wav_samples": lengths,
            "last_lines": [last[-1].strip(), last_p[-1].strip()]}


def phase_qs_tts(gen, card, with_profile=False):
    """Phase 14, (a) to (d); ``with_profile`` adds the profiles of one
    analysis-synthesis, one GAN step and one predictor step."""
    t0 = time.perf_counter()
    result = {"analysis_synthesis": phase_qs_analysis_synthesis(gen, card, with_profile)}
    result["training"] = phase_qs_training(card, with_profile)
    result["step_card_vs_cpu"] = phase_qs_step_card_vs_cpu()
    result["predictor_training"] = phase_qs_predictor_training(card, result["training"]["checkpoint"], with_profile)
    result["entry_points"] = phase_qs_entry_points(card)
    result["phase_s"] = time.perf_counter() - t0
    log(f"[14] QS-TTS phase {result['phase_s']:.1f}s")
    return result


# ------------------------------------------------------------- the ISTFT recipe
# Phase 15: examples/csmsc/configs/msmc_vq_gan_istft.yaml at full width and
# depth on seeded weights (the repository holds no trained ISTFT checkpoint):
# the HiFi-GAN trunk's two stages (x6, x5: 18 MRF layers through kernel 5),
# then the spectral head and the inverse STFT (hop 10, n_fft 40), x300 in all.
ISTFT_YAML = os.path.join(ROOT, "examples", "csmsc", "configs", "msmc_vq_gan_istft.yaml")
ISTFT_LENGTHS = (512, 448, 389, 300)  # analysis-synthesis batch of 4, bucket 512 (phases 15-18)
ISTFT_LAYERS = 18  # 2 stages x 3 blocks x 3 dilations


def _recipe_config(path, save_dir=None, warmup_steps=None, dropout=None, seed=1234, precision=None, quantizer=None):
    """A shipped recipe's config with the smoke's save dir, warmup length,
    seed, ``precision``, (``dropout``) every dropout rate of the
    autoencoder set and (``quantizer``) options of its quantizer_config."""
    from msmctts_tpu_torch.config import Config

    cfg = Config(path)
    cfg["seed"] = seed
    if quantizer:
        cfg.task["autoencoder"]["quantizer_config"].update(quantizer)
    if precision is not None:
        cfg["precision"] = precision
    if save_dir is not None:
        cfg["save_checkpoint_dir"] = save_dir
    if warmup_steps is not None:
        cfg.trainer["warmup_steps"] = warmup_steps
    if dropout is not None:
        ae = cfg.task["autoencoder"]
        for node in (ae["encoder_config"], ae["frame_decoder_config"]):
            node["dropout"] = node["attn_dropout"] = dropout
        ae["quantizer_config"]["dropout"] = dropout
        ae["quantizer_config"]["prior_config"]["p_dropout"] = dropout
    return cfg


def _seeded_trainer(cfg, device):
    """The recipe's trainer on seeded weights, decoder gains in [0.5, 1.5]."""
    from msmctts_tpu_torch.config import component_kwargs
    from msmctts_tpu_torch.registry import get_trainer
    from msmctts_tpu_torch.tasks import build_task

    task = build_task(cfg, device=device, mode="train")
    trainer = get_trainer(cfg.trainer["_name"])(cfg, task, **component_kwargs(cfg.trainer))
    trainer.init_state()
    _audible(trainer.ae.decoder, cfg["seed"])
    return trainer


def _mrf_stages(decoder_config):
    """(channels, upsample) per stage of a HiFi-GAN trunk: the shapes its MRF
    layers run at."""
    c0 = int(decoder_config["upsample_initial_channel"])
    return [(c0 // 2 ** (i + 1), int(u)) for i, u in enumerate(decoder_config["upsample_rates"])]


def _seeded_analysis_synthesis(gen, card, path, tag, what, seed, decoder, with_profile=False):
    """A recipe's analysis-synthesis on seeded weights (decoder gains in [0.5,
    1.5]; its decoder a ``decoder``): a small input against the CPU, then a
    batch of 4 rows of ``ISTFT_LENGTHS`` frames in bucket 512 with launches
    (2 ``vq_nearest`` and a ``fused_resblock_layer`` per MRF layer), wav
    lengths of exactly the recipe's samples a frame, first and warm times, and
    both kernels held against their plain versions at this path's shapes."""
    from msmctts_tpu_torch.tasks import build_task
    from msmctts_tpu_torch.weights import init_random, load_numpy_state, state_dict_numpy

    cfg = _recipe_config(path)
    task = build_task(cfg, device="cuda")
    ae = task.networks["autoencoder"]
    init_random(ae, 1234)
    _audible(ae.decoder, 1234)
    ae.eval()
    sr, ratio, stages = task.samplerate, ae.frameshift_ratio, _mrf_stages(ae.decoder_config)
    if type(ae.decoder).__name__ != decoder:
        raise AssertionError(f"{what} recipe: decoder {type(ae.decoder).__name__}, expected {decoder}")
    n_params = sum(p.numel() for p in ae.parameters())
    n_layers = 9 * len(stages)  # 3 blocks x 3 dilations per stage
    rng = np.random.default_rng(seed)

    cpu = build_task(cfg, device="cpu")
    load_numpy_state(cpu.networks["autoencoder"], state_dict_numpy(ae))
    small = {"mel": rng.normal(size=(1, 64, 80)).astype(np.float32) * 0.5, "mel_length": np.array([64])}
    got, want = task.analysis_synthesis(small), cpu.analysis_synthesis(small)
    err = float(np.abs(got["wav"][0] - want["wav"][0]).max())
    with torch.inference_mode():
        gi = ae.analysis(torch.as_tensor(small["mel"], device="cuda"), torch.tensor([64], device="cuda"))
        ci = cpu.networks["autoencoder"].analysis(torch.as_tensor(small["mel"]), torch.tensor([64]))
    idx_equal = all(torch.equal(a.cpu(), b) for a, b in zip(gi["quantizer_indices"], ci["quantizer_indices"]))
    log(f"{tag} {what} autoencoder {n_params / 1e6:.1f}M parameters (seeded), {ratio} samples a frame, MRF stages "
        f"(channels, upsample) {stages}; analysis-synthesis T=64 at {sr} Hz, card "
        f"vs CPU: indices equal {idx_equal}, wav max abs err {err:.3g} (|wav| max {np.abs(want['wav'][0]).max():.3g})")
    if err > AS_TOL or not idx_equal or got["wav"][0].shape != (64 * ratio,):
        raise AssertionError(f"{what} analysis-synthesis disagrees with the CPU: err {err}, indices equal {idx_equal}")
    del cpu

    lengths = np.array(ISTFT_LENGTHS)
    mel = rng.normal(size=(len(lengths), FRAMES, 80)).astype(np.float32) * 0.5
    mel *= (np.arange(FRAMES)[None, :] < lengths[:, None])[..., None]
    batch = {"mel": mel, "mel_length": lengths}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    task.analysis_synthesis(batch)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    _reset_counts()
    out = task.analysis_synthesis(batch)
    torch.cuda.synchronize()
    counts = _counts()
    _check_wavs(out["wav"], lengths, ratio, f"{what} analysis-synthesis")
    log(f"{tag} analysis-synthesis B={len(lengths)} frames {lengths.tolist()} (bucket {FRAMES}): launches {counts}, "
        f"wav samples {[w.shape[0] for w in out['wav']]}, |wav| max {max(float(np.abs(w).max()) for w in out['wav']):.3g}")
    if counts != {"vq_nearest": 2, "vq_nearest_stats": 0, "fused_resblock_layer": n_layers}:
        raise AssertionError(f"{what} analysis-synthesis launches {counts}, expected 2 VQ and {n_layers} resblock")
    warm = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        task.analysis_synthesis(batch)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
    warm_ms = statistics.median(warm)
    audio_s = float(lengths.sum()) * ratio / sr
    log(f"{tag} {what} analysis-synthesis per batch on {card}: first {first_ms:.1f} ms, warm median {warm_ms:.1f} ms "
        f"(runs {[round(w, 1) for w in warm]}), {audio_s:.2f} s of audio, {audio_s / warm_ms * 1e3:.1f}x real time")
    profile = (profile_call(lambda: task.analysis_synthesis(batch), tag, f"{what} analysis-synthesis")
               if with_profile else None)

    snap_rows = _hold_snaps(_snap_rows(ae, lambda: task.analysis_synthesis(batch)), f"{what} analysis-synthesis", tag)
    rows, worst = _resblock_layers(gen, len(lengths), FRAMES, f"{what} decode", library=True, stages=stages)
    keys = ("ms", "plain_ms", "library_ms", "bound_fp32_ms")
    rb_total = {key: sum(r[key] for r in rows) for key in keys}
    rb_total["bound_ms"] = sum(r["bound"][0] for r in rows)
    rb_total["max_abs_err"] = worst
    rb_total["shapes"] = sorted({(r["C"], r["T"]) for r in rows}, reverse=True)
    rb_total["per_width"] = {C: {k: sum(r[k] for r in rows if r["C"] == C) for k in ("ms", "library_ms", "plain_ms")}
                             for C, _ in stages}
    log(f"{tag} resblock, all {n_layers} layers of one {what} decode (B={len(lengths)}, {FRAMES} frames; kernel / "
        f"plain / cuDNN fp32 / 3xTF32 bound): {json.dumps(rb_total)}")
    return {"params": n_params, "cpu_wav_err": err, "launches": counts, "first_ms": first_ms, "warm_ms": warm_ms,
            "warm_runs_ms": warm, "audio_s": audio_s, "rtf_x": audio_s / warm_ms * 1e3, "snap": snap_rows,
            "resblock": rb_total, "resblock_rows": rows, "profile": profile}


def _recipe_training(make_trainer, batch_np, lengths, card, tag, what, with_profile=False):
    """2 warmup + 2 GAN steps of ``make_trainer()`` (``warmup_steps`` 2) at
    batch 16 (bucket 400) with the windows of its recipe, which the decoder
    must emit exactly: launches (2 ``vq_nearest_stats`` a step), which
    tensors moved, first and warm ms, peak memory, kernel 2 held against
    plain on one step's inputs; the state saved as ``model_4``."""
    from msmctts_tpu_torch.data.loader import to_device
    from msmctts_tpu_torch.training.base_trainer import metrics_to_host

    torch.cuda.empty_cache()
    base_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    trainer = make_trainer()
    ae, disc = trainer.ae, trainer.disc
    batch = to_device(batch_np, "cuda")
    window = trainer.sample_lengths
    emitted = []
    hook = ae.decoder.register_forward_hook(lambda m, a, o: emitted.append(tuple(o.shape)))
    log(f"{tag} {what} recipe training: {sum(p.numel() for p in ae.parameters()) / 1e6:.1f}M + discriminator "
        f"{sum(p.numel() for p in disc.parameters()) / 1e6:.1f}M parameters; batch {TRAIN_B}, frames "
        f"{lengths.min()}-{lengths.max()} (bucket {TRAIN_FRAMES}), windows of {window} samples "
        f"({trainer.frame_lengths} frames)")
    steps = []
    for it in range(1, 5):
        phase = "warmup" if it <= trainer.warmup_steps else "gan"
        ae_before = [p.detach().clone() for p in ae.parameters()]
        d_before = [p.detach().clone() for p in disc.parameters()]
        emitted.clear()
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch, it)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = _counts()
        host = metrics_to_host(metrics)
        bad = [k for k, v in host.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"{what} train step {it}: non-finite metrics {bad}")
        if counts != {"vq_nearest": 0, "vq_nearest_stats": 2, "fused_resblock_layer": 0}:
            raise AssertionError(f"{what} train step {it}: launches {counts}, expected 2 vq_nearest_stats only")
        if emitted != ([] if phase == "warmup" else [(TRAIN_B, window, 1)]):
            raise AssertionError(f"{what} train step {it} ({phase}): the decoder emitted {emitted}, "
                                 f"expected {TRAIN_B} windows of {window} samples")
        ae_moved, d_moved = _moved(ae, ae_before), _moved(disc, d_before)
        if ae_moved == 0 or (phase == "warmup") != (d_moved == 0):
            raise AssertionError(f"{what} train step {it} ({phase}): moved ae {ae_moved}, discriminator {d_moved}")
        steps.append({"iteration": it, "phase": phase, "ms": ms, "launches": counts, "metrics": host,
                      "ae_tensors_moved": ae_moved, "d_tensors_moved": d_moved})
        shown = {k: round(host[k], 4) for k in ("g_loss", "vq_loss", "frame_loss", "d_loss", "stft_loss", "fm_loss") if k in host}
        log(f"{tag} {what} step {it} ({phase}): {ms:.1f} ms, launches {counts}, moved ae {ae_moved} d {d_moved}, {shown}")
    hook.remove()

    def timed(it):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch, it)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    warm = {"warmup": [timed(1) for _ in range(3)], "gan": [timed(5 + i) for i in range(3)]}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    stats = _stats_rows(ae, lambda: trainer.train_step(batch, 8))
    if len(stats) != 2:
        raise AssertionError(f"{what} train step: {len(stats)} quantizer calls, expected 2")
    result = {"steps": steps, "warm_ms": {k: statistics.median(v) for k, v in warm.items()}, "warm_runs_ms": warm,
              "peak_memory_gib": peak_gib, "peak_above_start_gib": peak_gib - base_gib,
              "launches_per_step": steps[-1]["launches"], "stats": _hold_stats(stats, f"{what} train step", tag)}
    log(f"{tag} {what} per train step on {card}: first {[round(st['ms'], 1) for st in steps]} ms; warm median "
        f"{json.dumps({k: round(v, 1) for k, v in result['warm_ms'].items()})} ms; peak memory {peak_gib:.2f} GiB")
    if with_profile:
        result["profile"] = profile_call(lambda: trainer.train_step(batch, 9), tag, f"{what} GAN step")
    trainer.iteration = 4
    result["checkpoint"] = trainer.save()
    log(f"{tag} trained {what} autoencoder -> {os.path.relpath(result['checkpoint'], ROOT)}")
    return result


def _from_fixture(trainer):
    """The trained fixture's encoder, quantizer and codebook (the ISTFT and
    LJSpeech recipes share their shapes with CSMSC's) under the trainer's
    seeded decoder and discriminator. A seeded codebook has near-empty clusters,
    whose EMA division magnifies rounding (a card-vs-CPU step) and whose
    codewords can pass float16's range (a stripped copy)."""
    from msmctts_tpu_torch.utils.checkpoint import load_checkpoint
    from msmctts_tpu_torch.weights import train_state_from_jax, train_state_to_jax

    state = train_state_to_jax(trainer.ae, trainer.disc)
    fixture = load_checkpoint(FIXTURE)["state"]
    ae = state["params"]["autoencoder"]
    for k, v in fixture["params"]["autoencoder"].items():
        if k == "quantizer":  # a learned upsampler (up_i) of the options keeps its seeded weights
            ae[k].update(v)
        elif k != "decoder":
            ae[k] = v
    state["codebook"] = fixture["codebook"]
    train_state_from_jax(state, trainer.ae, trainer.disc)
    return state


def _step_card_vs_cpu(path, lengths, frameshift, seed, tag, what, quantizer=None):
    """One warmup and one GAN step of the recipe at ``path`` (its quantizer
    options updated by ``quantizer``) from equal state on the card and on
    the CPU: 2 short utterances, dropout 0, given window starts; the state
    is ``_from_fixture``'s."""
    from msmctts_tpu_torch.data.loader import to_device
    from msmctts_tpu_torch.training.base_trainer import metrics_to_host
    from msmctts_tpu_torch.weights import train_state_from_jax

    rng = np.random.default_rng(seed)
    batch = _train_batch(rng, lengths, max(lengths), frameshift=frameshift)
    starts = np.array([11, 3])
    out, state = {}, None
    for device in ("cuda", "cpu"):
        cfg = _recipe_config(path, os.path.join(SMOKE_DIR, "ckpt_step_card_vs_cpu"), warmup_steps=1, dropout=0.0,
                             quantizer=quantizer)
        trainer = _seeded_trainer(cfg, device)
        if state is None:
            state = _from_fixture(trainer)
        else:
            train_state_from_jax(state, trainer.ae, trainer.disc)
        indices = []
        hooks = [q.register_forward_hook(lambda m, a, o: indices.append(o[2].cpu())) for q in trainer.ae.quantizer.quantizer]
        dev_batch = to_device(batch, device)
        m1 = metrics_to_host(trainer.train_step(dev_batch, 1))
        m2 = metrics_to_host(trainer.train_step(dev_batch, 2, starts=torch.as_tensor(starts, device=device)))
        for h in hooks:
            h.remove()
        out[device] = {"warmup": m1, "gan": m2, "indices": indices, "codebook": _codebook_state(trainer.ae)}
        del trainer
    worst = {"loss_rel": 0.0, "codebook_abs": 0.0}
    for phase in ("warmup", "gan"):
        for k, want in out["cpu"][phase].items():
            got = out["cuda"][phase][k]
            rel = abs(got - want) / max(abs(want), 1e-3)
            worst["loss_rel"] = max(worst["loss_rel"], rel)
            if rel > STEP_TOL["loss_rtol"]:
                raise AssertionError(f"{what} {phase} step, {k}: card {got} vs CPU {want}")
    same = all(torch.equal(a, b) for a, b in zip(out["cuda"]["indices"], out["cpu"]["indices"]))
    for a, b in zip(out["cuda"]["codebook"], out["cpu"]["codebook"]):
        for x, y in zip(a, b):
            worst["codebook_abs"] = max(worst["codebook_abs"], float((x - y).abs().max()))
    log(f"{tag} one {what} warmup + one GAN step, card vs CPU (B=2, {max(lengths)} frames): indices equal {same} "
        f"({len(out['cuda']['indices'])} stage passes), worst loss rel diff {worst['loss_rel']:.3g}, "
        f"worst codebook abs diff {worst['codebook_abs']:.3g}")
    if not same or worst["codebook_abs"] > STEP_TOL["codebook_atol"]:
        raise AssertionError(f"{what} train step disagrees with the CPU: indices equal {same}, {worst}")
    return {**worst, "indices_equal": same, "card": {k: out["cuda"][k] for k in ("warmup", "gan")},
            "cpu": {k: out["cpu"][k] for k in ("warmup", "gan")}}


def phase_istft_predict(card, ae_ckpt, seed=1234):
    """(c) Text -> wav through the CSMSC AM recipe (seeded predictor) over the
    ISTFT autoencoder of (b): 4 snaps and 18 MRF launches per batch; the
    streaming decode is refused, as in the JAX package."""
    from msmctts_tpu_torch.config import Config
    from msmctts_tpu_torch.data.datasets import TEXT_BUCKETS, bucket_length
    from msmctts_tpu_torch.tasks import build_task
    from msmctts_tpu_torch.utils.checkpoint import save_checkpoint
    from msmctts_tpu_torch.weights import init_random, multi_stage_predictor_to_jax, state_dict_numpy

    cfg = Config(AM_YAML)
    cfg.task["autoencoder"]["_checkpoint"] = ae_ckpt
    cfg.task["autoencoder"].pop("_config", None)
    task = build_task(cfg, device="cuda")
    predictor = task.networks["predictor"]
    init_random(predictor, seed)
    predictor.bias_durations(4.2)
    am_path = os.path.join(SMOKE_DIR, "am_istft_seeded.ckpt")
    save_checkpoint(am_path, {"params": {"predictor": multi_stage_predictor_to_jax(state_dict_numpy(predictor))}}, 0,
                    cfg.to_dict())
    task.pre_infer()
    ae = task.networks["autoencoder"]
    if type(ae.decoder).__name__ != "ISTFTGenerator" or ae.frameshift_ratio != 300:
        raise AssertionError(f"the AM's autoencoder: decoder {type(ae.decoder).__name__}, ratio {ae.frameshift_ratio}")
    rng = np.random.default_rng(seed)
    n_symbols = list(cfg.task["predictor"]["n_symbols"])
    n_phones = [24, 57, 96, 128]
    Lt = bucket_length(max(n_phones), TEXT_BUCKETS)
    batch = {"text": _text(rng, n_phones, n_symbols, Lt), "text_length": np.array(n_phones)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    task.predict(batch)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    _reset_counts()
    out = task.predict(batch)
    torch.cuda.synchronize()
    counts = _counts()
    _check_wavs(out["wav"], out["mel_length"], 300, "predict over the ISTFT autoencoder")
    if counts != {"vq_nearest": 4, "vq_nearest_stats": 0, "fused_resblock_layer": ISTFT_LAYERS}:
        raise AssertionError(f"predict over the ISTFT autoencoder: launches {counts}, expected 4 VQ and {ISTFT_LAYERS} resblock")
    warm = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        task.predict(batch)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
    try:
        task.predict_stream(batch, chunk_frames=SERVE_CHUNK)
    except NotImplementedError as e:
        refused = str(e)
    else:
        raise AssertionError("predict_stream over an ISTFT decoder was not refused")
    warm_ms = statistics.median(warm)
    audio_s = float(np.sum(out["mel_length"])) * 300 / task.samplerate
    log(f"[15] predict over the ISTFT autoencoder, B={len(n_phones)} phones {n_phones} (text bucket {Lt}), frames "
        f"{out['mel_length'].tolist()}: launches {counts}; on {card}: first {first_ms:.1f} ms, warm median "
        f"{warm_ms:.1f} ms (runs {[round(w, 1) for w in warm]}), {audio_s / warm_ms * 1e3:.1f}x real time; "
        f"predict_stream refused: {refused}")
    return {"launches": counts, "frames": out["mel_length"].tolist(), "first_ms": first_ms, "warm_ms": warm_ms,
            "warm_runs_ms": warm, "audio_s": audio_s, "stream_refused": refused, "am_path": am_path}


def _write_mel_corpus(d, n_utts=12, seed=17, frameshift=300, sr=24000):
    """A small MelDataset corpus: mel/*.npy [T, 80], wav/*.wav (T x 300 samples at 24 kHz), train.list."""
    from msmctts_tpu_torch.data.datasets import save_wav

    rng = np.random.default_rng(seed)
    for sub in ("mel", "wav"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    ids, frames = [], []
    for i in range(n_utts):
        uid, f = f"ae{i:03d}", int(rng.integers(60, 200))
        np.save(os.path.join(d, "mel", f"{uid}.npy"), (rng.normal(size=(f, 80)) * 0.5).astype(np.float32))
        save_wav(os.path.join(d, "wav", f"{uid}.wav"), rng.normal(size=f * frameshift) * 0.1, sr)
        ids.append(uid)
        frames.append(f)
    with open(os.path.join(d, "train.list"), "w") as fh:
        fh.write("\n".join(ids) + "\n")
    return ids, frames


def phase_istft_entry_points(card):
    """(d) The train entry point (``msmctts_tpu_torch.train.main``, in
    process: phase 18 runs it as a process) on the ISTFT recipe for 2 steps
    (warmup, then GAN) behind the feed over a corpus written here, then
    ``infer`` (in process) from its checkpoint on 3 utterances, each run's
    launches counted."""
    import shutil

    import yaml
    from scipy.io import wavfile

    from msmctts_tpu_torch import infer, train

    d = os.path.join(SMOKE_DIR, "istft_corpus")
    ids, frames = _write_mel_corpus(d)
    cfg = _recipe_config(ISTFT_YAML, os.path.join(SMOKE_DIR, "ckpt_istft_cli"), warmup_steps=1)
    shutil.rmtree(cfg["save_checkpoint_dir"], ignore_errors=True)
    cfg["dataloader"] = {"batch_size": 4, "num_workers": 2}
    cfg.dataset["id_list"] = os.path.join(d, "train.list")
    cfg.dataset["feature_path"] = [os.path.join(d, "mel", "{}.npy"), os.path.join(d, "wav", "{}.wav")]
    cfg_path = os.path.join(SMOKE_DIR, "istft_cli.yaml")
    with open(cfg_path, "w") as fh:
        yaml.safe_dump(cfg.to_dict(), fh)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    trainer = train.main(["-c", cfg_path, "--max-steps", "2", "--log-every", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_counts = _counts()
    del trainer
    torch.cuda.empty_cache()
    ckpt = os.path.join(cfg["save_checkpoint_dir"], "model_2")
    text = "".join(open(os.path.join(cfg["save_checkpoint_dir"], f)).read()
                   for f in os.listdir(cfg["save_checkpoint_dir"]) if f.endswith(".log"))
    last = [line for line in text.splitlines() if "step 2" in line]
    if not last or not os.path.exists(ckpt) or "d_loss" not in last[-1]:
        raise AssertionError(f"the ISTFT recipe's train run wrote no GAN step 2 / model_2:\n{text[-3000:]}")
    if train_counts["vq_nearest_stats"] != 4:
        raise AssertionError(f"2 ISTFT steps through train(): launches {train_counts}, expected 2 statistics calls a step")
    log(f"[15] train entry point, in process, ISTFT recipe, 2 steps at batch 4 ({wall:.1f}s; launches {train_counts}): "
        f"{last[-1].strip()}")
    test_list = os.path.join(SMOKE_DIR, "istft_test.yaml")
    with open(test_list, "w") as fh:
        yaml.safe_dump({u: {"mel": os.path.join(d, "mel", f"{u}.npy")} for u in ids[:3]}, fh)
    out_dir = os.path.join(SMOKE_DIR, "istft_infer")
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    infer.main(["-m", ckpt, "-t", test_list, "-o", out_dir])
    torch.cuda.synchronize()
    infer_wall = time.perf_counter() - t0
    infer_counts = _counts()
    lengths = {u: wavfile.read(os.path.join(out_dir, f"{u}_wav.wav"))[1].shape[0] for u in ids[:3]}
    want = {u: f * 300 for u, f in zip(ids[:3], frames[:3])}
    want_counts = {"vq_nearest": 2 * 3, "vq_nearest_stats": 0, "fused_resblock_layer": 18 * 3}  # one utterance a batch
    if lengths != want or infer_counts != want_counts:
        raise AssertionError(f"infer wrote wavs of {lengths} samples (expected {want}), launches {infer_counts} "
                             f"(expected {want_counts})")
    log(f"[15] infer entry point, in process ({infer_wall:.1f}s): wav samples {lengths}, launches {infer_counts}")
    return {"train_wall_s": wall, "infer_wall_s": infer_wall, "wav_samples": lengths, "last_line": last[-1].strip(),
            "train_launches": train_counts, "infer_launches": infer_counts}


def phase_istft(gen, card, with_profile=False):
    """Phase 15, (a) to (d)."""
    t0 = time.perf_counter()
    result = {"analysis_synthesis": _seeded_analysis_synthesis(gen, card, ISTFT_YAML, "[15]", "ISTFT", 15,
                                                              "ISTFTGenerator", with_profile)}
    batch_np, lengths, _ = _training_batch()
    make = lambda: _seeded_trainer(_recipe_config(ISTFT_YAML, os.path.join(SMOKE_DIR, "ckpt_istft"), warmup_steps=2), "cuda")
    result["training"] = _recipe_training(make, batch_np, lengths, card, "[15]", "ISTFT", with_profile)
    result["step_card_vs_cpu"] = _step_card_vs_cpu(ISTFT_YAML, [64, 48], 300, 16, "[15]", "ISTFT")
    result["predict"] = phase_istft_predict(card, result["training"]["checkpoint"])
    result["entry_points"] = phase_istft_entry_points(card)
    result["phase_s"] = time.perf_counter() - t0
    log(f"[15] ISTFT phase {result['phase_s']:.1f}s")
    return result


# ------------------------------------------------------------- the int8 decoder
# Phase 16: the int8 HiFi-GAN decoder (ops/int8_generator.py) over the trained
# fixture: calibrated on the first batch it decodes; every conv site but
# conv_post an s8 x s8 -> s32 product (torch._int_mm on the card) against its
# plain version (fp64 per-tap sums), int8 against fp32, then predict, a
# streamed batch, the daemon and infer with --int8.
PEAK_INT8 = 1979e12  # dense int8 tensor-core operations per second (published, 700 W)
INT8_REL = 0.05  # int8 vs fp32 decode, relative L2: the JAX package's own generator bound
INT8_TASK_REL = 0.25  # int8 vs fp32 through a task, the JAX package's own bound
INT8_SITES = 77  # conv_pre, 4 transposed convs, 72 MRF convs (conv_post stays fp32)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _int8_sites(run):
    """Run ``run()`` and return every int8 product it launched: (xq, w_q,
    padding, dilation)."""
    from msmctts_tpu_torch.ops import int8_generator as i8

    calls, launch = [], i8.int8_conv1d

    def record(xq, w_q, padding, dilation=1):
        calls.append((xq, w_q, padding, dilation))
        return launch(xq, w_q, padding, dilation)

    i8.int8_conv1d = record
    try:
        run()
    finally:
        i8.int8_conv1d = launch
    return calls


def phase_int8_decoder(card, with_profile=False):
    """(a) The fixture's analysis-synthesis through the int8 decoder."""
    import torch.nn.functional as F

    from msmctts_tpu_torch.config import Config
    from msmctts_tpu_torch.ops import int8_generator as i8
    from msmctts_tpu_torch.tasks import build_task
    from msmctts_tpu_torch.utils.checkpoint import load_checkpoint

    ckpt = load_checkpoint(FIXTURE)
    task = build_task(Config(ckpt["config"]), device="cuda")
    task.load_variables(ckpt["state"])
    ae = task.networks["autoencoder"]
    rng = np.random.default_rng(16)
    lengths = np.array(ISTFT_LENGTHS)
    mel = rng.normal(size=(len(lengths), FRAMES, 80)).astype(np.float32) * 0.5
    mel *= (np.arange(FRAMES)[None, :] < lengths[:, None])[..., None]
    batch = {"mel": mel, "mel_length": lengths}
    fp32 = task.analysis_synthesis(batch)
    task.int8_decoder = True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    task.analysis_synthesis(batch)  # the first batch: quantize, calibrate, decode
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    dec = task._int8_state
    _reset_counts()
    i8.LAUNCHES["int8_conv1d"] = 0
    out = task.analysis_synthesis(batch)
    torch.cuda.synchronize()
    counts = {**_counts(), "int8_conv1d": i8.LAUNCHES["int8_conv1d"]}
    _check_wavs(out["wav"], lengths, ae.frameshift_ratio, "int8 analysis-synthesis")
    if counts != {"vq_nearest": 2, "vq_nearest_stats": 0, "fused_resblock_layer": 0, "int8_conv1d": INT8_SITES}:
        raise AssertionError(f"int8 analysis-synthesis launches {counts}, expected 2 VQ and {INT8_SITES} int8 products")
    rel = [_rel_l2(a, b) for a, b in zip(out["wav"], fp32["wav"])]
    log(f"[16] int8 analysis-synthesis of the fixture, B={len(lengths)} frames {lengths.tolist()}: launches {counts}; "
        f"int8 vs fp32 relative L2 per utterance {[round(r, 4) for r in rel]} (bound {INT8_REL}); "
        f"{len(dec.scales)} static scales, SmoothQuant alpha {dec.smooth_alpha}")
    if max(rel) > INT8_REL:
        raise AssertionError(f"int8 decode vs fp32: relative L2 {max(rel)} > {INT8_REL}")

    with torch.inference_mode():
        feats = ae.encode_features(torch.as_tensor(mel, device="cuda"), torch.as_tensor(lengths, device="cuda"))
    # every product at its site's shapes against its plain version, bit-equal int32, with times
    calls = _int8_sites(lambda: dec.apply(feats))
    if len(calls) != INT8_SITES:
        raise AssertionError(f"{len(calls)} int8 products in one decode, expected {INT8_SITES}")
    sites, agg = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for n, (xq, w_q, padding, dilation) in enumerate(calls):
        y = i8.int8_conv1d(xq, w_q, padding, dilation)
        ref = i8.int8_conv1d_plain(xq, w_q, padding, dilation)
        torch.cuda.synchronize()
        if y.dtype != torch.int32 or not torch.equal(y, ref):
            raise AssertionError(f"int8 product {n} {tuple(xq.shape)} x {tuple(w_q.shape)} d={dilation}: "
                                 f"{int((y != ref).sum())} sums differ from the plain version")
        Bx, T_out, C_out = y.shape
        k, C_in, _ = w_q.shape
        ops = 2 * Bx * T_out * C_out * k * C_in
        nbytes = xq.numel() + w_q.numel() + 4 * y.numel()
        b = bound(nbytes, ops, PEAK_INT8)
        xf, wf = xq.float().transpose(1, 2).contiguous(), w_q.float().permute(2, 1, 0).contiguous()
        row = {"site": n, "x": list(xq.shape), "w": list(w_q.shape), "dilation": dilation, "padding": padding,
               "ms": time_ms(lambda: i8.int8_conv1d(xq, w_q, padding, dilation), runs=3, reps=3, warmup=1),
               "plain_ms": time_ms(lambda: i8.int8_conv1d_plain(xq, w_q, padding, dilation), runs=2, reps=3, warmup=1),
               "library_ms": time_ms(lambda: F.conv1d(xf, wf, padding=padding, dilation=dilation), runs=3, reps=3, warmup=1),
               "bound_ms": b[0], "bound_by": b[1]}
        sites.append(row)
        for key in agg:
            agg[key] += row[key]
    log(f"[16] int8 products, all {len(sites)} sites of one decode (B={len(lengths)}, {FRAMES} frames): int32 sums "
        f"bit-equal to the plain version at every site; per decode: _int_mm {agg['ms']:.3f} ms, plain fp64 "
        f"{agg['plain_ms']:.3f} ms, cuDNN fp32 conv at the same shapes {agg['library_ms']:.3f} ms, int8 bound "
        f"{agg['bound_ms']:.4f} ms")
    for row in sorted(sites, key=lambda r: -r["ms"])[:6]:
        log(f"[16]   int8 product {json.dumps(row)}")

    # int8 and fp32 decode of the same features, device time by events
    int8_ms = time_ms(lambda: dec.apply(feats), runs=3, reps=3, warmup=1)
    with torch.inference_mode():
        fp32_ms = time_ms(lambda: ae.decoder(feats), runs=3, reps=3, warmup=1)
    log(f"[16] decode of B={len(lengths)} x {FRAMES} frames on {card}: int8 {int8_ms:.2f} ms, fp32 {fp32_ms:.2f} ms "
        f"(CUDA events, whole decoder)")
    profile = profile_call(lambda: dec.apply(feats), "[16]", "int8 decode") if with_profile else None

    # the same int8 state on the CPU (the plain products) on the card's features, T = 64
    small = feats[:1, :64].contiguous()
    card_wav = dec.apply(small).cpu().numpy()
    cpu_wav = dec.apply(small.cpu()).numpy()
    cpu_err = float(np.abs(card_wav - cpu_wav).max())
    log(f"[16] int8 decode T=64, card vs CPU (plain products, the same int8 state and features): max abs err {cpu_err:.3g}")
    if cpu_err > AS_TOL:
        raise AssertionError(f"int8 decode on the card vs the CPU: {cpu_err}")
    return {"launches": counts, "rel_l2_vs_fp32": rel, "first_ms": first_ms, "int8_decode_ms": int8_ms,
            "fp32_decode_ms": fp32_ms, "products": agg, "sites": sites, "cpu_err": cpu_err, "profile": profile}


def _batch_invariance_witness(eng, texts):
    """Each of ``texts`` in the batch it arrives in (consecutive groups of
    the engine's batch size, as the daemon's first batches are) against the
    same text alone, through the engine's task, fp32 and int8, in three
    settings: the JAX package's batching (text padded to the bucket of the
    batch's longest request, no frame margin), that with the engine's frame
    margin, and the engine's (its one text length and its margin). Returns
    the worst relative L2 and max abs difference of each."""
    from msmctts_tpu_torch.data.datasets import TEXT_BUCKETS, bucket_length
    from msmctts_tpu_torch.serving import parse_phone_string

    task, margin = eng.task, eng.task.frame_margin

    def ladder(batch):  # the JAX package's text padding: the bucket of the longest request
        Lt = bucket_length(int(batch["text_length"].max()), TEXT_BUCKETS)
        return {"text": batch["text"][:, :Lt], "text_length": batch["text_length"]}

    settings = {"jax_batching": (0, ladder), "jax_batching_with_margin": (margin, ladder),
                "engine": (margin, lambda b: b)}
    groups = [texts[g:g + eng.batch_size] for g in range(0, len(texts), eng.batch_size)]
    out = {}
    try:
        for name, (m, pad) in settings.items():
            task.frame_margin = m
            for int8 in (False, True):
                task.int8_decoder = int8
                worst = {"rel_l2": 0.0, "max_abs": 0.0, "phones": None}
                for group in groups:
                    shared = task.predict(pad(eng.batch_of([parse_phone_string(t) for t in group])))
                    for i, t in enumerate(group):
                        solo = task.predict(pad(eng.batch_of([parse_phone_string(t)])))["wav"][0]
                        got = shared["wav"][i]
                        if got.shape != solo.shape:
                            raise AssertionError(f"{name}: {len(t.split())} phones, {got.shape} samples in a batch, "
                                                 f"{solo.shape} alone")
                        rel = _rel_l2(got, solo)
                        if rel >= worst["rel_l2"]:
                            worst = {"rel_l2": rel, "max_abs": float(np.abs(got - solo).max()), "phones": len(t.split())}
                out[f"{name}_{'int8' if int8 else 'fp32'}"] = worst
    finally:
        task.frame_margin, task.int8_decoder = margin, True
    log(f"[16] a request beside others vs alone, in process, worst per setting (frame margin {margin}, text length "
        f"{eng.text_length}): {json.dumps(out)}")
    for key in ("engine_fp32", "engine_int8"):
        if out[key]["max_abs"] > AS_TOL:
            raise AssertionError(f"the engine's batching: a request in a batch vs alone: {out[key]}")
    return out


def phase_int8_serving(card, am_path):
    """(b) ``predict`` with the int8 decoder and one streamed batch at chunk
    64 against it; (c) ``serve --int8`` as a subprocess under 8 clients and
    ``infer --int8`` on 3 lines."""
    import shutil
    import threading

    import yaml

    from msmctts_tpu_torch.ops import cuda_build
    from msmctts_tpu_torch.ops import int8_generator as i8
    from msmctts_tpu_torch.serving import BatchingEngine

    task = _load_tts_task(am_path, "cuda")
    n_symbols = list(task.networks["predictor"].n_symbols)
    rng = np.random.default_rng(16)
    n_phones = [64, 57, 40, 33]
    Lt = 64
    dur = rng.integers(4, 7, size=(SERVE_B, Lt)).astype(np.float32) * (np.arange(Lt)[None] < np.array(n_phones)[:, None])
    batch = {"text": _text(rng, n_phones, n_symbols, Lt), "text_length": np.array(n_phones), "dur": dur}
    fp32 = task.predict(batch)
    task.int8_decoder = True
    task.predict(batch)  # calibrates
    _reset_counts()
    i8.LAUNCHES["int8_conv1d"] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = task.predict(batch)
    torch.cuda.synchronize()
    predict_ms = (time.perf_counter() - t0) * 1e3
    counts = {**_counts(), "int8_conv1d": i8.LAUNCHES["int8_conv1d"]}
    if counts != {"vq_nearest": 4, "vq_nearest_stats": 0, "fused_resblock_layer": 0, "int8_conv1d": INT8_SITES}:
        raise AssertionError(f"predict --int8: launches {counts}")
    rel = [_rel_l2(a, b) for a, b in zip(out["wav"], fp32["wav"])]
    if max(rel) > INT8_TASK_REL:
        raise AssertionError(f"predict --int8 vs fp32: relative L2 {max(rel)}")
    _reset_counts()
    i8.LAUNCHES["int8_conv1d"] = 0
    t0 = time.perf_counter()
    meta, chunks = task.predict_stream(batch, chunk_frames=SERVE_CHUNK)
    pieces, first_ms = [], None
    for c in chunks:
        pieces.append(c)
        if first_ms is None:
            first_ms = (time.perf_counter() - t0) * 1e3
    stream_ms = (time.perf_counter() - t0) * 1e3
    stream_counts = {**_counts(), "int8_conv1d": i8.LAUNCHES["int8_conv1d"]}
    want_counts = {"vq_nearest": 4, "vq_nearest_stats": 0, "fused_resblock_layer": 0,
                   "int8_conv1d": INT8_SITES * len(pieces)}
    if stream_counts != want_counts or len(pieces) < 4:
        raise AssertionError(f"int8 streamed batch: {len(pieces)} windows, launches {stream_counts}, expected {want_counts}")
    streamed = np.concatenate(pieces, axis=1)
    diff = max(float(np.abs(streamed[i, : w.shape[0]] - w).max()) for i, w in enumerate(out["wav"]))
    log(f"[16] predict --int8, B={SERVE_B} phones {n_phones} (forced durations): launches {counts}, {predict_ms:.1f} ms "
        f"on {card}; int8 vs fp32 relative L2 {[round(r, 4) for r in rel]} (bound {INT8_TASK_REL}); streamed at chunk "
        f"{SERVE_CHUNK}: {len(pieces)} windows, launches {stream_counts}, first chunk {first_ms:.1f} ms, whole "
        f"{stream_ms:.1f} ms, stream vs int8 predict max abs diff {diff:.3g}")
    if diff > AS_TOL:
        raise AssertionError(f"int8 stream vs int8 predict: {diff}")

    # the daemon with --int8 under 8 clients
    eng = BatchingEngine(_load_tts_task(am_path, "cuda"), sample_rate=task.samplerate, batch_size=SERVE_B, window_ms=0.0,
                         max_frames=SERVE_MAX_FRAMES, stream_chunk_frames=SERVE_CHUNK)
    eng.task.int8_decoder = True
    texts = [_phone_string(_text(rng, [int(n)], n_symbols, int(n))[0])
             for n in rng.integers(SERVE_PHONES[0], SERVE_PHONES[1] + 1, 12)]
    requests = [(t, False) for t in texts] + [(t, True) for t in texts[:SERVE_REQUESTS // 4]]
    # the daemon and infer --int8 start first: their starts overlap the in-process references;
    # infer ends before the load begins
    proc, lines, _ = _start_daemon("-m", am_path, "--port", "0", "--batch-size", str(SERVE_B), "--max-frames",
                                   str(SERVE_MAX_FRAMES), "--int8")
    test_list = os.path.join(SMOKE_DIR, "int8_test.yaml")
    with open(test_list, "w") as fh:
        yaml.safe_dump({f"i8_{i}": {"text": t} for i, t in enumerate(texts[:3])}, fh)
    out_dir = os.path.join(SMOKE_DIR, "int8_infer")
    shutil.rmtree(out_dir, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t_infer = time.perf_counter()
    infer_proc = subprocess.Popen([sys.executable, "-m", "msmctts_tpu_torch.infer", "-m", am_path, "-t", test_list, "-o",
                                   out_dir, "--int8"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
    _CHILDREN.append(infer_proc)
    eng.start(warmup={})  # the daemon's warmup: its first batch calibrates
    try:
        alone = {t: eng.synthesize(t, timeout=SERVE_TIMEOUT_S) for t in texts}
    finally:
        eng.stop()
    witness = _batch_invariance_witness(eng, texts[:3 * SERVE_B])
    infer_out, infer_err = infer_proc.communicate(timeout=600)
    infer_wall = time.perf_counter() - t_infer
    builds_before = cuda_build.build_count()
    try:
        warm_line = _wait_for_line(lines, "warmup:", proc, SERVE_TIMEOUT_S, "[16]")
        if f"frame margin {eng.task.frame_margin}," not in warm_line:  # as the in-process engine's
            raise AssertionError(f"the int8 daemon's frame margin is not {eng.task.frame_margin}: {warm_line.rstrip()}")
        port = int(_wait_for_line(lines, "serving on", proc, 60, "[16]").rsplit(":", 1)[1])
        results = [None] * len(requests)

        def client(worker):
            for i in range(worker, len(requests), SERVE_CLIENTS):
                t, stream = requests[i]
                results[i] = _http(port, "POST", "/synthesize", {"text": t, "stream": stream})

        threads = [threading.Thread(target=client, args=(w,)) for w in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(SERVE_TIMEOUT_S)
        load_s = time.perf_counter() - t0
        if any(r is None for r in results):
            raise AssertionError("the int8 daemon's load did not finish")
        stats = json.loads(_http(port, "GET", "/stats")[1])
        if proc.poll() is not None:
            raise AssertionError(f"the int8 daemon died with {proc.returncode}")
    finally:
        _stop(proc)
    # each request as it was served under load, against the same request alone in process (as
    # phase 13 holds the fp32 daemon): among them a 32-phone request that, batched as the JAX
    # package batches, came out 1.03 apart (relative L2)
    worst, rels = 0.0, []
    for (t, stream), (status, data, _, _) in zip(requests, results):
        if status != 200:
            raise AssertionError(f"int8 daemon, {len(t.split())} phones (stream {stream}): {status} {data[:300]!r}")
        pcm = _pcm(data, stream) / 32767.0
        if pcm.shape != alone[t].shape or not np.isfinite(pcm).all() or not np.abs(pcm).max() > 1e-3:
            raise AssertionError(f"int8 daemon: {pcm.shape} samples, in-process {alone[t].shape}")
        worst = max(worst, float(np.abs(pcm - alone[t]).max()))
        rels.append((len(t.split()), stream, round(_rel_l2(pcm, alone[t]), 5)))
    log(f"[16] int8 daemon under load vs in-process int8 engine (frame margin {eng.task.frame_margin}), "
        f"(phones, streamed, relative L2 incl. 16-bit PCM rounding) per request: {rels}")
    if stats["cold_shapes"] != 0 or stats["kernel_builds"] != 0 or stats["errors"] != 0 or not stats["mean_batch_size"] > 1:
        raise AssertionError(f"int8 daemon /stats: {stats}")
    if worst > AS_TOL or cuda_build.build_count() != builds_before:
        raise AssertionError(f"int8 daemon under load vs in-process int8 engine: max abs err {worst}")
    lat = sorted(r[3] for (_, s), r in zip(requests, results) if not s)
    log(f"[16] int8 daemon on {card}: {warm_line.strip()}; {len(requests)} requests from {SERVE_CLIENTS} clients in "
        f"{load_s:.2f}s, blocking p50 {statistics.median(lat) * 1e3:.1f} ms; served vs in-process int8 engine max abs "
        f"err {worst:.3g}; /stats cold_shapes {stats['cold_shapes']}, kernel_builds {stats['kernel_builds']}, "
        f"errors {stats['errors']}, mean batch {stats['mean_batch_size']:.2f}")

    wavs = sorted(f for f in os.listdir(out_dir) if f.endswith("_wav.wav")) if os.path.isdir(out_dir) else []
    if infer_proc.returncode != 0 or len(wavs) != 3:
        raise AssertionError(f"infer --int8 failed ({infer_proc.returncode}), wrote {wavs}:\n{infer_out[-3000:]}\n"
                             f"{infer_err[-3000:]}")
    log(f"[16] infer --int8 on 3 lines ({infer_wall:.1f}s, beside the daemon's start and the in-process references): "
        f"{infer_out.strip().splitlines()[-1]}")
    return {"predict": {"launches": counts, "ms": predict_ms, "rel_l2_vs_fp32": rel},
            "stream": {"windows": len(pieces), "launches": stream_counts, "first_chunk_ms": first_ms,
                       "stream_ms": stream_ms, "max_abs_diff_vs_predict": diff},
            "daemon": {"warmup_line": warm_line.strip(), "load_s": load_s, "latency_p50_ms": statistics.median(lat) * 1e3,
                       "served_err": worst, "per_request_rel_l2": rels, "stats": stats,
                       "frame_margin": eng.task.frame_margin, "batch_witness": witness},
            "infer_wall_s": infer_wall}


def phase_int8(card, am_path, with_profile=False):
    """Phase 16, (a) to (c); ``with_profile`` adds the profile of one int8 decode."""
    t0 = time.perf_counter()
    result = {"decoder": phase_int8_decoder(card, with_profile), "serving": phase_int8_serving(card, am_path)}
    result["phase_s"] = time.perf_counter() - t0
    log(f"[16] int8 phase {result['phase_s']:.1f}s")
    return result


# ------------------------------------------------------------- int8 fine-tuning and the quality tools
# Phase 17: QAT of the fixture's int8 decoder (ops/qat_int8.py, tools/qat_int8.py),
# the AS-MCD sweep (tools/as_mcd_sweep.py, utils/audio.py), debug_step and infer
# --debug, and the trainer's evaluate() with utils/logger.Logger, on a seeded
# corpus written here.
QAT_UTTS, QAT_LENGTHS = 16, (221, 401)  # the corpus: 16 utterances of 221-400 frames
QAT_STEPS, QAT_REFRESH = 20, 10  # at the tool's defaults otherwise: batch 8, windows of 64 frames, lr 1e-5
QAT_BATCH, QAT_WINDOW, QAT_LR, QAT_L1 = 8, 64, 1e-5, 0.1
# one QAT step card vs CPU from the same state. Adam's first step moves a weight by lr x the sign of its
# gradient wherever |g| >> eps, and the step's L1 losses take the sign of each residual, so a residual
# near 0 that the two devices round apart flips its share of the gradient: the step's gradients part by
# 18 % relative L2 and the updates by 2 lr at 7.5 % of the entries (H100 vs CPU; on the CPU alone an input
# moved by 1e-6 relative moves the gradient 3.3 %, at batch 2). The backward is held on a fixed
# cotangent instead (1e-6 on the input moves that 1 % on the CPU), overall and at the worst site
QAT_VJP_REL, QAT_VJP_SITE_REL = 0.05, 0.25
QAT_ADAM_ATOL = 1e-3  # the card's update against Adam's step from its own gradient, in units of lr
QAT_UPDATE_MOVED = 0.5  # the card's mean |update| against lr: the step moved the weights
# the fake-quant forward against the true int8 decode of the same kernels and grid: both round every
# activation, the one after fp32 sums, the other after exact int32 sums, and over 77 sites a code that
# one rounds the other way moves later codes too (4.5e-3 on the CPU at T = 64; the JAX package holds
# 2e-3 on its 12-site test generator); the bound is about half the int8 decode's own error against fp32
QAT_FQ_REL = 0.015
QAT_SNAPSHOT = 12020  # the name of the QAT output among the sweep's snapshots (the fixture is model_12000)
SWEEP_UTTS = 4
MCD_CPU_TOL = 0.01  # dB, the sweep's fp32 scores, card vs CPU
EMB_TOL = 1e-5  # debug_step's quantized embeddings against the plain snap's codewords
QAT_DIR = os.path.join(SMOKE_DIR, "qat")


class _RecordingWriter:
    """A tensorboard writer that keeps what it is given (``utils/logger.Logger.writer``)."""

    def __init__(self):
        self.calls = []

    def add_scalar(self, name, value, step):
        self.calls.append(("scalar", name, float(value), step))

    def add_image(self, name, img, step, dataformats="HWC"):
        self.calls.append(("image", name, np.asarray(img), step))

    def add_audio(self, name, wav, step, sample_rate=None):
        self.calls.append(("audio", name, np.asarray(wav), step))

    def close(self):
        pass


def _qat_corpus():
    """16 seeded utterances as ``MelDataset`` reads them, their id list, the
    sweep's list of the first 4, and a copy of the fixture whose config reads
    this corpus (the sweep's first snapshot)."""
    import shutil

    from msmctts_tpu_torch.data.datasets import save_wav
    from msmctts_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    shutil.rmtree(QAT_DIR, ignore_errors=True)
    rng = np.random.default_rng(170)
    for sub in ("mel", "wav", "snapshots", "ref"):
        os.makedirs(os.path.join(QAT_DIR, sub), exist_ok=True)
    ids, frames = [], []
    for i in range(QAT_UTTS):
        uid, f = f"qat{i:03d}", int(rng.integers(*QAT_LENGTHS))
        np.save(os.path.join(QAT_DIR, "mel", f"{uid}.npy"), (rng.normal(size=(f, 80)) * 0.5).astype(np.float32))
        save_wav(os.path.join(QAT_DIR, "wav", f"{uid}.wav"), rng.normal(size=f * 300) * 0.1, 24000)
        ids.append(uid)
        frames.append(f)
    lists = {"train": os.path.join(QAT_DIR, "train.list"), "sweep": os.path.join(QAT_DIR, "sweep.list")}
    for name, n in (("train", QAT_UTTS), ("sweep", SWEEP_UTTS)):
        with open(lists[name], "w") as fh:
            fh.write("\n".join(ids[:n]) + "\n")
    ckpt = load_checkpoint(FIXTURE)
    ds = ckpt["config"]["dataset"]
    ds["id_list"] = lists["train"]
    ds["feature_path"] = [os.path.join(QAT_DIR, "mel", "{}.npy"), os.path.join(QAT_DIR, "wav", "{}.wav")]
    base = os.path.join(QAT_DIR, "snapshots", f"model_{ckpt['iteration']}")
    save_checkpoint(base, ckpt["state"], ckpt["iteration"], ckpt["config"])
    return {"ids": ids, "frames": frames, "lists": lists, "base": base}


def _fq_vs_int8(qat, fw, decoder_config):
    """Relative L2 of the fake-quant forward against the true int8 decode of
    the same folded kernels on the same grid (scales, SmoothQuant) and inputs."""
    from msmctts_tpu_torch.ops import int8_generator as i8

    flat = {s: (n["w"].detach().cpu().numpy(), None if n["bias"] is None else n["bias"].detach().cpu().numpy())
            for s, n in qat.folded.items()}
    qparams = i8.qparams_to(i8._quantize_folded(flat, decoder_config, qat.smooth), qat.device)
    x = torch.as_tensor(fw, device=qat.device)
    with torch.no_grad():
        fq = qat.forward(x)
    true = i8.int8_generator_apply(qparams, x, decoder_config, act_scales=qat.scales)[..., 0]
    return _rel_l2(fq.cpu().numpy(), true.cpu().numpy())


def _leaf_spans(qat):
    """{site: (first, end)} of each fake-quant site's tensors in ``qat.leaves()``."""
    spans, a = {}, 0
    for site, node in qat.folded.items():
        b = a + sum(v is not None for v in node.values())
        spans[site] = (a, b)
        a = b
    return spans


def _in_process(main, *argv):
    """An entry point's ``main(argv)`` in this process, its stdout captured
    -> (an object with ``stdout``, seconds)."""
    import contextlib
    import io
    import types

    out, t0 = io.StringIO(), time.perf_counter()
    with contextlib.redirect_stdout(out):
        main(list(argv))
    return types.SimpleNamespace(stdout=out.getvalue()), time.perf_counter() - t0


def _subprocess(what, *args, timeout=600):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=timeout)
    if res.returncode != 0:
        raise AssertionError(f"{what} failed ({res.returncode}):\n{res.stdout[-4000:]}\n{res.stderr[-4000:]}")
    return res, time.perf_counter() - t0


def phase_qat(gen, card, corpus, with_profile=False):
    """(a) The tool's precompute on the card (kernels 1 and 5 held against
    plain at its shapes), QAT steps at the tool's defaults with a
    calibration refresh, one step card vs CPU, the written checkpoint served
    through ``Int8Decoder``, then the tool and ``infer --int8`` of its
    output, in process."""
    import shutil

    from msmctts_tpu_torch.config import Config
    from msmctts_tpu_torch.ops import int8_generator as i8
    from msmctts_tpu_torch.tasks import build_task
    from msmctts_tpu_torch.tools import qat_int8 as tool
    from msmctts_tpu_torch.training.base_trainer import build_dataset_from_config
    from msmctts_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    ckpt = load_checkpoint(corpus["base"])
    config = Config(ckpt["config"])
    task = build_task(config, device="cuda")
    task.load_variables(ckpt["state"])
    ae = task.networks["autoencoder"]
    dec_cfg = {k: (list(v) if isinstance(v, (list, tuple)) else v) for k, v in dict(ae.decoder_config).items()}
    hop, sr = ae.frameshift_ratio, int(config.dataset["samplerate"])
    dataset = build_dataset_from_config(config, training=False, id_list=corpus["lists"]["train"])

    # the precompute: one analysis-synthesis per utterance
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    feats_db, wav_db = tool.precompute(ae, dataset, 160, hop, "cuda")
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) * 1e3
    pre_counts = _counts()
    want = {"vq_nearest": 2 * QAT_UTTS, "vq_nearest_stats": 0, "fused_resblock_layer": 36 * QAT_UTTS}
    if pre_counts != want or [f.shape[0] for f in feats_db] != corpus["frames"]:
        raise AssertionError(f"QAT precompute: launches {pre_counts} (expected {want}), "
                             f"frames {[f.shape[0] for f in feats_db]}")
    log(f"[17] QAT precompute of {QAT_UTTS} utterances ({min(corpus['frames'])}-{max(corpus['frames'])} frames), "
        f"one at a time: {pre_ms:.1f} ms, launches {pre_counts}")
    # kernels 1 and 5 at the precompute's shapes: the longest utterance, padded to its frame bucket
    # as the precompute's loader pads it (the decoder runs over the padded frames)
    longest = int(np.argmax(corpus["frames"]))
    row = dataset.collate_fn([dataset[longest]])
    T_long, T_pad = corpus["frames"][longest], int(row["mel"].shape[1])
    mel = torch.as_tensor(row["mel"], device="cuda")
    length = torch.as_tensor(row["mel_length"], device="cuda")

    def one():
        with torch.inference_mode():
            ae.decoder(ae.encode_features(mel, length))

    snap_rows = _hold_snaps(_snap_rows(ae, one), "QAT precompute", tag="[17]")
    rb_rows, rb_err = _resblock_layers(gen, 1, T_pad, "QAT precompute", library=True, runs=3, reps=3, warmup=1)
    rb = {key: sum(r[key] for r in rb_rows) for key in ("ms", "plain_ms", "library_ms", "bound_fp32_ms")}
    rb.update(bound_ms=sum(r["bound"][0] for r in rb_rows), max_abs_err=rb_err,
              shapes=f"B=1, {T_long} frames padded to {T_pad}: T = {', '.join(str(T_pad * u) for u in (6, 30, 150, 300))}")
    log(f"[17] QAT precompute, the 36 MRF layers at B=1, {T_pad} frames (the {T_long}-frame utterance in its "
        f"bucket) against plain: {json.dumps(rb)}")

    # the fine-tune: the tool's state, windows and steps
    calib = torch.as_tensor(feats_db[0][None], device="cuda")
    t0 = time.perf_counter()
    qat = tool.QAT(tool.fold_decoder_params(ae.decoder), dec_cfg, sr, QAT_LR, QAT_L1, 1.0, calib)
    torch.cuda.synchronize()
    calib_ms = (time.perf_counter() - t0) * 1e3
    eval_rng = np.random.default_rng(tool.EVAL_SEED)
    eval_batches = [tool.sample_windows(eval_rng, feats_db, wav_db, QAT_BATCH, QAT_WINDOW, hop)
                    for _ in range(tool.EVAL_BATCHES)]
    gap0 = qat.gap(eval_batches)
    fq0 = _fq_vs_int8(qat, eval_batches[0][0], dec_cfg)

    # one step from the same folded kernels, grid and window batch on the card and on the CPU. The losses
    # are means over the batch, which a code that one device rounds the other way moves (see QAT_FQ_REL).
    # The update is held in two parts: the backward of the fake-quant graph card vs CPU (the gradient of
    # a fixed cotangent, taken before the step), and the card's update against Adam's first step from the
    # card's own gradient; the step's own gradients, card vs CPU, are printed (see QAT_VJP_REL)
    fw, ww = tool.sample_windows(np.random.default_rng(171), feats_db, wav_db, QAT_BATCH, QAT_WINDOW, hop)
    cot = np.random.default_rng(172).standard_normal((QAT_BATCH, QAT_WINDOW * hop)).astype(np.float32)
    twins, vjps = [], []
    for dev in ("cuda", "cpu"):
        # a twin calibrates on a few frames, then takes the fine-tune's grid
        twin = tool.QAT({s: {k: None if v is None else v.detach().to(dev) for k, v in n.items()}
                         for s, n in qat.folded.items()}, dec_cfg, sr, QAT_LR, QAT_L1, 1.0, calib[:, :16].to(dev))
        twin._set_grid(qat.scales, qat.smooth)
        y = twin.forward(torch.as_tensor(fw, device=dev))
        grads = torch.autograd.grad((y * torch.as_tensor(cot, device=dev)).sum(), twin.leaves())
        vjps.append((y.detach().cpu(), {site: torch.cat([g.flatten().cpu() for g in grads[a:b]])
                                        for site, (a, b) in _leaf_spans(twin).items()}))
        twins.append(twin)
    on_card, on_cpu = twins
    (y_card, vjp_card), (y_cpu, vjp_cpu) = vjps
    site_rel = {site: _rel_l2(vjp_card[site], vjp_cpu[site]) for site in vjp_cpu}
    vjp_rel = _rel_l2(torch.cat(list(vjp_card.values())), torch.cat(list(vjp_cpu.values())))
    start = torch.cat([v.detach().cpu().flatten() for v in on_card.leaves()])
    m_card, m_cpu = on_card.step(fw, ww).cpu().numpy(), on_cpu.step(fw, ww).cpu().numpy()
    loss_rel = float(np.max(np.abs(m_card - m_cpu) / np.maximum(np.abs(m_cpu), 1e-12)))
    flat = lambda twin, f: torch.cat([f(v).detach().cpu().flatten() for v in twin.leaves()])
    g_card, g_cpu = flat(on_card, lambda v: v.grad), flat(on_cpu, lambda v: v.grad)
    d_card, d_cpu = flat(on_card, lambda v: v) - start, flat(on_cpu, lambda v: v) - start
    g64 = g_card.double()
    adam = -QAT_LR * g64 / (g64.abs() + on_card.opt.defaults["eps"])  # Adam's first step: both moments bias-corrected
    # the stored weight rounds w + update to half an ulp of w
    adam_err = float(((d_card.double() - adam).abs() - start.double().abs() * 2.0 ** -23).max())
    worst = max(site_rel, key=site_rel.get)
    upd = {"entries": d_card.numel(), "forward_rel_l2": _rel_l2(y_card, y_cpu), "vjp_rel_l2": vjp_rel,
           "vjp_worst_site": [worst, site_rel[worst]], "step_grad_rel_l2": _rel_l2(g_card, g_cpu),
           "card_update_mean_abs": float(d_card.abs().mean()), "cpu_update_mean_abs": float(d_cpu.abs().mean()),
           "update_vs_adam_excess": adam_err, "opposite_share": float((d_card * d_cpu < 0).float().mean())}
    log(f"[17] one QAT step (batch {QAT_BATCH} x {QAT_WINDOW} frames), card vs CPU from the same folded kernels and "
        f"grid: losses {m_card.tolist()} vs {m_cpu.tolist()} (max rel {loss_rel:.3g}); forward, backward and update "
        f"(lr {QAT_LR}): {json.dumps(upd)}")
    if (loss_rel > STEP_TOL["loss_rtol"] or not np.isfinite(m_card).all() or vjp_rel > QAT_VJP_REL
            or site_rel[worst] > QAT_VJP_SITE_REL or adam_err > QAT_ADAM_ATOL * QAT_LR
            or upd["card_update_mean_abs"] < QAT_UPDATE_MOVED * QAT_LR):
        raise AssertionError(f"QAT step card vs CPU: losses rel {loss_rel}, update {upd}")
    del on_card, on_cpu, twins

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, metrics, last = [], [], [time.perf_counter()]

    def on_step(step, m):
        torch.cuda.synchronize()  # a step's time runs from the end of the one before it (with its refresh)
        now = time.perf_counter()
        step_ms.append((now - last[0]) * 1e3)
        last[0] = now
        metrics.append(m.cpu().numpy())

    refreshes = tool.run(qat, feats_db, wav_db, QAT_STEPS, QAT_BATCH, QAT_WINDOW, hop, QAT_REFRESH, 0, on_step=on_step)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if not np.isfinite(np.array(metrics)).all() or refreshes != 1 or len(metrics) != QAT_STEPS:
        raise AssertionError(f"QAT steps: metrics {metrics}, refreshes {refreshes}")
    gap1 = qat.gap(eval_batches)
    fq1 = _fq_vs_int8(qat, eval_batches[0][0], dec_cfg)
    warm = statistics.median(step_ms[1:])
    log(f"[17] QAT on {card}: {QAT_STEPS} steps at batch {QAT_BATCH} x {QAT_WINDOW} frames, lr {QAT_LR}, "
        f"{refreshes} calibration refresh: first {step_ms[0]:.1f} ms, warm median {warm:.1f} ms, peak {peak_gib:.2f} GiB; "
        f"calibration {calib_ms:.1f} ms; mel loss {metrics[0][0]:.4f} -> {metrics[-1][0]:.4f}; fake-quant log-mel gap "
        f"{gap0:.4f} -> {gap1:.4f}; fake-quant forward vs the true int8 decode, relative L2 {fq0:.3g} -> {fq1:.3g}")
    if max(fq0, fq1) > QAT_FQ_REL:
        raise AssertionError(f"the fake-quant forward is {max(fq0, fq1)} from the int8 decode (bound {QAT_FQ_REL})")
    profile = profile_call(lambda: qat.step(fw, ww), "[17]", "QAT step") if with_profile else None

    # the written checkpoint through Int8Decoder, as the tool writes it
    state = ckpt["state"]
    dec_params = state["params"]["autoencoder"]["decoder"]
    state["params"]["autoencoder"] = dict(state["params"]["autoencoder"], decoder=tool.unfold_to_weight_norm(
        qat.folded, dict(dec_params), dec_cfg))
    out = os.path.join(QAT_DIR, "snapshots", f"model_{QAT_SNAPSHOT}")
    save_checkpoint(out, state, ckpt["iteration"], ckpt["config"])
    served = build_task(config, device="cuda")
    served.load_variables(load_checkpoint(out)["state"])
    lengths = np.array(ISTFT_LENGTHS)
    mel = np.random.default_rng(16).normal(size=(len(lengths), FRAMES, 80)).astype(np.float32) * 0.5
    mel *= (np.arange(FRAMES)[None, :] < lengths[:, None])[..., None]
    batch = {"mel": mel, "mel_length": lengths}
    rel = {}
    for name, t in (("ptq", task), ("qat", served)):
        fp32 = t.analysis_synthesis(batch)
        t.int8_decoder = True
        out8 = t.analysis_synthesis(batch)  # calibrates on this batch
        rel[name] = [_rel_l2(a, b) for a, b in zip(out8["wav"], fp32["wav"])]
    i8.LAUNCHES["int8_conv1d"] = 0
    calls = _int8_sites(lambda: served.analysis_synthesis(batch))
    bad = [n for n, (xq, w_q, p, d) in enumerate(calls)
           if not torch.equal(i8.int8_conv1d(xq, w_q, p, d), i8.int8_conv1d_plain(xq, w_q, p, d))]
    log(f"[17] the QAT checkpoint through Int8Decoder (B={len(lengths)}, bucket {FRAMES}): {len(calls)} int8 products, "
        f"int32 sums bit-equal to plain at {len(calls) - len(bad)}; int8 vs fp32 relative L2 per utterance "
        f"{[round(r, 4) for r in rel['qat']]} (the fixture's PTQ on the same batch {[round(r, 4) for r in rel['ptq']]})")
    if len(calls) != INT8_SITES or bad or max(rel["qat"]) > INT8_REL:
        raise AssertionError(f"QAT checkpoint int8: {len(calls)} products, differing {bad}, rel {rel['qat']}")
    del served

    # the tool as a user runs it
    cli_out = os.path.join(QAT_DIR, "cli_qat")
    from msmctts_tpu_torch.tools import qat_int8

    t0 = time.perf_counter()  # the tool's main, in process
    line = qat_int8.main(["--ckpt", corpus["base"], "--id-list", corpus["lists"]["train"], "--steps", "4",
                          "--out", cli_out])
    tool_s = time.perf_counter() - t0
    if line.get("out") != cli_out or line.get("steps") != 4 or not os.path.exists(cli_out):
        raise AssertionError(f"the QAT tool's last line {line}")
    log(f"[17] the QAT tool, in process, --steps 4 ({tool_s:.1f}s): {json.dumps(line)}")
    from scipy.io import wavfile

    from msmctts_tpu_torch import infer

    out_dir = os.path.join(QAT_DIR, "infer_int8")
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.synchronize()
    _reset_counts()
    i8.LAUNCHES["int8_conv1d"] = 0
    t0 = time.perf_counter()  # in process: phase 16 runs infer --int8 as its own process
    infer.main(["-m", cli_out, "-t", corpus["lists"]["sweep"], "-o", out_dir, "--int8"])
    torch.cuda.synchronize()
    inf_s = time.perf_counter() - t0
    inf_counts = {**_counts(), "int8_conv1d": i8.LAUNCHES["int8_conv1d"]}
    want_counts = {"vq_nearest": 2 * SWEEP_UTTS, "vq_nearest_stats": 0, "fused_resblock_layer": 0,
                   # one utterance a batch, and the first batch once more through the
                   # dynamic int8 graph, whose activations calibrate the static scales
                   "int8_conv1d": INT8_SITES * (SWEEP_UTTS + 1)}
    lengths_out = {u: wavfile.read(os.path.join(out_dir, f"{u}_wav.wav"))[1].shape[0] for u in corpus["ids"][:SWEEP_UTTS]}
    want_len = {u: f * hop for u, f in zip(corpus["ids"][:SWEEP_UTTS], corpus["frames"][:SWEEP_UTTS])}
    if lengths_out != want_len or inf_counts != want_counts:
        raise AssertionError(f"infer --int8 of the QAT checkpoint wrote {lengths_out} (expected {want_len}), "
                             f"launches {inf_counts} (expected {want_counts})")
    log(f"[17] infer --int8 of the tool's checkpoint, in process ({inf_s:.1f}s): wav samples {lengths_out}, "
        f"launches {inf_counts}")
    return {"precompute_ms": pre_ms, "launches_precompute": pre_counts, "snap": snap_rows, "resblock": rb,
            "calibration_ms": calib_ms, "step_first_ms": step_ms[0], "step_warm_ms": warm, "step_ms": step_ms,
            "peak_gib": peak_gib, "gap": [gap0, gap1], "fq_vs_int8_rel": [fq0, fq1], "card_vs_cpu": {
                "loss_rel": loss_rel, **upd}, "int8_rel_l2": rel, "checkpoint": out,
            "tool_s": tool_s, "tool_line": line, "infer_int8_s": inf_s, "infer_int8_launches": inf_counts,
            "profile": profile}


def phase_as_mcd(card, corpus):
    """(b) The sweep over the fixture and the QAT checkpoint: fp32 (counted)
    and ``--int8`` on the card, fp32 on the CPU, all in process; the
    reference wavs are the fixture's fp32 decode of each utterance's mel."""
    from msmctts_tpu_torch.config import Config
    from msmctts_tpu_torch.data.datasets import save_wav
    from msmctts_tpu_torch.data.loader import finite_loader
    from msmctts_tpu_torch.tasks import build_task
    from msmctts_tpu_torch.tools import as_mcd_sweep
    from msmctts_tpu_torch.training.base_trainer import build_dataset_from_config
    from msmctts_tpu_torch.utils.checkpoint import load_checkpoint

    ckpt = load_checkpoint(corpus["base"])
    config = Config(ckpt["config"])
    task = build_task(config, device="cuda")
    task.load_variables(ckpt["state"])
    dataset = build_dataset_from_config(config, training=False, id_list=corpus["lists"]["sweep"])
    for uid, batch in zip(corpus["ids"], finite_loader(dataset, 1)):
        wav = task.analysis_synthesis({k: batch[k] for k in ("mel", "mel_length")})["wav"][0]
        save_wav(os.path.join(QAT_DIR, "ref", f"{uid}.wav"), wav, 24000)
    del task
    args = ["--ckpt-dir", os.path.join(QAT_DIR, "snapshots"), "-t", corpus["lists"]["sweep"],
            "--ref-wav", os.path.join(QAT_DIR, "ref", "{}.wav")]
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    card_line = as_mcd_sweep.main([*args, "--device", "cuda"])
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    counts = _counts()
    n_batches = 2 * -(-SWEEP_UTTS // 2)  # 2 snapshots, batches of 2
    want = {"vq_nearest": 2 * n_batches, "vq_nearest_stats": 0, "fused_resblock_layer": 36 * n_batches}
    if counts != want:
        raise AssertionError(f"sweep launches {counts}, expected {want}")
    t0 = time.perf_counter()
    int8_line = as_mcd_sweep.main([*args, "--int8", "--device", "cuda"])
    int8_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_line = as_mcd_sweep.main([*args, "--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    log(f"[17] AS-MCD sweep, fp32 on the card ({card_s:.1f}s, launches {counts}): {json.dumps(card_line)}")
    log(f"[17] AS-MCD sweep, --int8 on the card ({int8_s:.1f}s): {json.dumps(int8_line)}")
    log(f"[17] AS-MCD sweep, fp32 on the CPU ({cpu_s:.1f}s): {json.dumps(cpu_line)}")
    diff = {k: abs(card_line["snapshots"][k] - cpu_line["snapshots"][k]) for k in card_line["snapshots"]}
    if sorted(card_line["snapshots"]) != sorted(int8_line["snapshots"]) or len(diff) != 2 or max(diff.values()) > MCD_CPU_TOL:
        raise AssertionError(f"AS-MCD: card vs CPU {diff} dB (bound {MCD_CPU_TOL}), snapshots {card_line}, {int8_line}")
    return {"fp32": card_line, "int8": int8_line, "cpu_fp32": cpu_line, "card_vs_cpu_db": diff, "launches": counts,
            "card_s": card_s, "int8_s": int8_s, "cpu_s": cpu_s}


def phase_debug(card, corpus):
    """(c) ``debug_step`` on the card over the sweep's first two utterances:
    indices against the plain snap, embeddings against its codewords, wavs
    against the CPU's ``analysis_synthesis``; then ``infer --debug``."""
    import shutil

    import yaml

    from msmctts_tpu_torch import infer
    from msmctts_tpu_torch.config import Config
    from msmctts_tpu_torch.data.loader import finite_loader
    from msmctts_tpu_torch.ops import vq
    from msmctts_tpu_torch.tasks import build_task
    from msmctts_tpu_torch.training.base_trainer import build_dataset_from_config
    from msmctts_tpu_torch.utils.checkpoint import load_checkpoint

    ckpt = load_checkpoint(corpus["base"])
    config = Config(ckpt["config"])
    task = build_task(config, device="cuda")
    task.load_variables(ckpt["state"])
    ae = task.networks["autoencoder"]
    batch = next(finite_loader(build_dataset_from_config(config, training=False, id_list=corpus["lists"]["sweep"]), 2))
    batch = {k: batch[k] for k in ("mel", "mel_length")}
    out = {}
    torch.cuda.synchronize()
    _reset_counts()
    snaps = _snap_rows(ae, lambda: out.update(task.debug_step(batch)))
    torch.cuda.synchronize()
    counts = _counts()
    if counts != {"vq_nearest": 4, "vq_nearest_stats": 0, "fused_resblock_layer": 36} or len(snaps) != 4:
        raise AssertionError(f"debug_step launches {counts}, {len(snaps)} snaps")
    rows = _hold_snaps(snaps[2:], "debug_step analysis", tag="[17]")
    emb_err = 0.0
    for s, idx, emb in zip(snaps[2:], out["indices"], out["embedding"]):
        ref_idx, ref_quant = vq.vq_nearest_plain(s["x"].contiguous(), s["embed"])
        if not np.array_equal(idx.reshape(-1, idx.shape[-1]), ref_idx.cpu().numpy()):
            raise AssertionError("debug_step indices differ from the plain snap's")
        emb_err = max(emb_err, float(np.abs(emb.reshape(ref_quant.shape) - ref_quant.cpu().numpy()).max()))
    cpu = build_task(config, device="cpu")
    cpu.load_variables(ckpt["state"])
    want = cpu.analysis_synthesis(batch)["wav"]
    wav_err = max(float(np.abs(a - b).max()) for a, b in zip(out["wav"], want))
    log(f"[17] debug_step B=2 frames {batch['mel_length'].tolist()}: launches {counts}; indices equal to the plain "
        f"snap's, embeddings max abs {emb_err:.3g}, wav vs the CPU's analysis-synthesis max abs {wav_err:.3g}")
    if emb_err > EMB_TOL or wav_err > AS_TOL:
        raise AssertionError(f"debug_step: embeddings {emb_err}, wav {wav_err}")
    # the CLI, saving the debug outputs
    cfg = dict(ckpt["config"], save_features=[["wav", ".npy"], ["indices", ".npy"], ["embedding", ".npy"]])
    cfg_path = os.path.join(QAT_DIR, "debug.yaml")
    with open(cfg_path, "w") as fh:
        yaml.safe_dump(cfg, fh)
    out_dir = os.path.join(QAT_DIR, "infer_debug")
    shutil.rmtree(out_dir, ignore_errors=True)
    infer.main(["-m", corpus["base"], "-c", cfg_path, "-t", corpus["lists"]["sweep"], "-o", out_dir, "-b", "2", "--debug",
                "--device", "cuda"])
    files = sorted(os.listdir(out_dir))
    first = corpus["ids"][0]
    cli_err = float(np.abs(np.load(os.path.join(out_dir, f"{first}_wav.npy")) - out["wav"][0]).max())
    if f"{first}_indices.npy" not in files or f"{first}_embedding.npy" not in files or cli_err > AS_TOL:
        raise AssertionError(f"infer --debug wrote {files}; wav vs debug_step {cli_err}")
    log(f"[17] infer --debug: {len(files)} files ({', '.join(files[:3])}, ...); wav vs debug_step max abs {cli_err:.3g}")
    return {"launches": counts, "snap": rows, "embedding_err": emb_err, "wav_vs_cpu": wav_err, "cli_files": len(files)}


def phase_evaluate(card, corpus, qat_ckpt):
    """(d) The CSMSC AE recipe at batch 16 for 2 steps through ``train`` with
    ``eval_inteval_iters: 2`` and a recording writer; ``evaluate`` without a
    writer; then a state stitched from the fixture's encoder and the QAT
    checkpoint's decoder."""
    import shutil

    from msmctts_tpu_torch.config import Config, component_kwargs
    from msmctts_tpu_torch.registry import get_trainer
    from msmctts_tpu_torch.tasks import build_task
    from msmctts_tpu_torch.training import base_trainer
    from msmctts_tpu_torch.utils.checkpoint import load_checkpoint
    from msmctts_tpu_torch.utils.logger import Logger

    def trainer_for(**extra):
        cfg = Config(AE_YAML)
        cfg.trainer["warmup_steps"] = 1
        cfg.trainer["eval_inteval_iters"] = 2
        cfg.dataset["id_list"] = corpus["lists"]["train"]
        cfg.dataset["feature_path"] = [os.path.join(QAT_DIR, "mel", "{}.npy"), os.path.join(QAT_DIR, "wav", "{}.wav")]
        cfg["dataloader"] = {"batch_size": TRAIN_B, "num_workers": 2}
        cfg["save_checkpoint_dir"] = os.path.join(QAT_DIR, "ckpt_eval")
        cfg["iters_per_checkpoint"] = 1000
        for k, v in extra.items():
            cfg[k] = v
        shutil.rmtree(cfg["save_checkpoint_dir"], ignore_errors=True)
        task = build_task(cfg, device="cuda", mode="train")
        return get_trainer(cfg.trainer["_name"])(cfg, task, **component_kwargs(cfg.trainer)), cfg

    writers, seen = [], []

    class RecordingLogger(Logger):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.writer = self.meter.writer = _RecordingWriter()
            self.meter.interval = 1
            writers.append(self.writer)

    trainer, cfg = trainer_for(pretrain_checkpoint_path=FIXTURE)
    evaluate = trainer.evaluate

    def counted(batch, logger, iteration):
        torch.cuda.synchronize()
        _reset_counts()
        evaluate(batch, logger, iteration)
        torch.cuda.synchronize()
        seen.append({"iteration": iteration, "launches": _counts(), "batch": {k: v[:1].cpu().numpy() for k, v in batch.items()}})

    trainer.evaluate = counted
    base_trainer.Logger, plain_logger = RecordingLogger, base_trainer.Logger
    try:
        t0 = time.perf_counter()
        trainer.train(max_steps=2, log_every=1)
        run_s = time.perf_counter() - t0
    finally:
        base_trainer.Logger = plain_logger
    w = writers[0].calls
    audio = [c for c in w if c[0] == "audio"]
    images = [c for c in w if c[0] == "image"]
    if len(seen) != 1 or seen[0]["iteration"] != 2 or len(audio) != 1 or len(images) != 1:
        raise AssertionError(f"evaluate ran {[s['iteration'] for s in seen]}; writer got {[c[:2] for c in w]}")
    if seen[0]["launches"] != {"vq_nearest": 2, "vq_nearest_stats": 0, "fused_resblock_layer": 36}:
        raise AssertionError(f"evaluate launches {seen[0]['launches']}, expected 2 VQ and 36 resblock")
    # its wav against the analysis-synthesis of that row with the trained state
    task = build_task(cfg, device="cuda")
    task.load_variables(trainer.state_tree())
    row = seen[0]["batch"]
    ref = task.analysis_synthesis({"mel": row["mel"], "mel_length": row["mel_length"]})["wav"][0]
    wav = audio[0][2][0]
    err = float(np.abs(wav - ref).max()) if wav.shape == ref.shape else float("inf")
    scalars = sorted({c[1] for c in w if c[0] == "scalar"})
    log(f"[17] train 2 steps at batch {TRAIN_B} with eval_inteval_iters 2 ({run_s:.1f}s): evaluate at iteration 2, "
        f"launches {seen[0]['launches']}; wav of {wav.shape[0]} samples vs the analysis-synthesis of that row max abs "
        f"{err:.3g}; image {images[0][2].shape}; {len(scalars)} scalars per step to the writer")
    if err > AS_TOL or not np.abs(wav).max() > 1e-3:
        raise AssertionError(f"evaluate's wav vs analysis-synthesis: {err}")
    # no writer: nothing runs
    _reset_counts()
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in row.items()}
    trainer.evaluate = evaluate
    trainer.evaluate(batch, Logger(os.path.join(QAT_DIR, "no_writer"), use_tensorboard=False), 3)
    if any(_counts().values()):
        raise AssertionError(f"evaluate without a writer launched {_counts()}")
    del trainer, task

    # stitching: the fixture's encoder, the QAT checkpoint's decoder
    parts = [["autoencoder/encoder", FIXTURE], ["autoencoder/decoder", qat_ckpt]]
    stitched, _ = trainer_for(restore_checkpoint_path=parts)
    stitched.attempt_resume()
    state = stitched.state_tree()["params"]["autoencoder"]
    held = {}
    for name, path in (("encoder", FIXTURE), ("decoder", qat_ckpt)):
        want = _flat_tree(load_checkpoint(path)["state"]["params"]["autoencoder"][name])
        got = _flat_tree(state[name])
        if sorted(got) != sorted(want) or not all(np.array_equal(got[k], want[k]) for k in want):
            raise AssertionError(f"stitched {name} differs from {path}")
        held[name] = len(want)
    log(f"[17] stitched state [[autoencoder/encoder, fixture], [autoencoder/decoder, QAT]]: {held['encoder']} encoder "
        f"and {held['decoder']} decoder tensors bit-equal to their checkpoints', iteration {stitched.iteration}")
    return {"launches": seen[0]["launches"], "wav_err": err, "train_s": run_s, "stitched_tensors": held}


def phase_quality_tools(gen, card, with_profile=False):
    """Phase 17, (a) to (d); ``with_profile`` adds the profile of one QAT step."""
    t0 = time.perf_counter()
    corpus = _qat_corpus()
    result = {"qat": phase_qat(gen, card, corpus, with_profile)}
    result["as_mcd"] = phase_as_mcd(card, corpus)
    result["debug"] = phase_debug(card, corpus)
    result["evaluate"] = phase_evaluate(card, corpus, result["qat"]["checkpoint"])
    result["phase_s"] = time.perf_counter() - t0
    log(f"[17] QAT and quality tools phase {result['phase_s']:.1f}s")
    return result


# ------------------------------------------------------------- LJSpeech
# Phase 18: the LJSpeech recipes (examples/ljspeech/configs/) at full width
# and depth on seeded weights (the repository holds no LJSpeech audio or
# checkpoint), and the tools of this slice: strip, synthesize
# --static-frames, the load generator against the daemon, train --profile
# and the reference-checkpoint converter.
LJ_AE_YAML = os.path.join(ROOT, "examples", "ljspeech", "configs", "msmc_vq_gan.yaml")
LJ_AM_YAML = os.path.join(ROOT, "examples", "ljspeech", "configs", "msmc_vq_gan_am.yaml")
LJ_DIR = os.path.join(SMOKE_DIR, "ljspeech")
LJ_HOP, LJ_SR = 256, 22050
LJ_LOAD_LEVELS = (1, 4, 16)
LJ_LOAD_REQUESTS = 12
LJ_SERVE_B = 8
# the daemon held to the in-process engine: 16 clients, every 8th request streamed, over
# 24 texts of load_test's 24-96 tokens (its p99 is the 2nd slowest of 112 blocking ones)
LJ_DAEMON_CLIENTS, LJ_DAEMON_REQUESTS, LJ_DAEMON_TEXTS = 16, 128, 24
LJ_STATIC_FRAMES = 512
LJ_PROFILE_STEPS = 15  # the trace covers steps 10-14 (the train CLI's window)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _lj_phones(rng, n):
    return " ".join(str(int(v)) for v in rng.integers(1, 256, n))


def phase_lj_tools(card, ae_ckpt, seed=1234):
    """(c) ``tools.strip_checkpoint --f16`` of (b)'s checkpoint as a
    subprocess; a seeded full-width LJSpeech AM over the stripped
    autoencoder; ``synthesize --static-frames`` against ``predict``; the
    daemon at batch 8 under ``tools.load_test --spawn`` at 1, 4 and 16
    clients."""
    from scipy.io import wavfile

    from msmctts_tpu_torch.ops import cuda_build
    from msmctts_tpu_torch.tasks import build_task
    from msmctts_tpu_torch.utils.checkpoint import read_checkpoint, save_checkpoint
    from msmctts_tpu_torch.weights import init_random, multi_stage_predictor_to_jax, state_dict_numpy

    stripped = os.path.join(LJ_DIR, "ae_stripped.f16.ckpt")
    from msmctts_tpu_torch.tools import strip_checkpoint

    res, strip_s = _in_process(strip_checkpoint.main, ae_ckpt, "-o", stripped, "--f16")
    slim = read_checkpoint(stripped)
    leaves = _flat_tree(slim["state"]).values()
    dtypes = sorted({str(v.dtype) for v in leaves})
    if set(slim["state"]) - {"params", "codebook", "model_state"} or "discriminator" in slim["state"]["params"] \
            or dtypes != ["float16"] or not all(np.isfinite(v).all() for v in leaves):
        raise AssertionError(f"stripped checkpoint: keys {sorted(slim['state'])}, dtypes {dtypes}, or a leaf not finite")
    log(f"[18] strip_checkpoint --f16 ({strip_s:.1f}s): {res.stdout.strip()}; leaves {dtypes}")

    cfg = _recipe_config(LJ_AM_YAML)
    cfg.task["autoencoder"]["_checkpoint"] = stripped
    cfg.task["autoencoder"].pop("_config", None)  # the stripped checkpoint's embedded config
    task = build_task(cfg, device="cuda")
    predictor = task.networks["predictor"]
    init_random(predictor, seed)
    predictor.bias_durations(4.2)
    am_path = os.path.join(LJ_DIR, "am_seeded.ckpt")
    save_checkpoint(am_path, {"params": {"predictor": multi_stage_predictor_to_jax(state_dict_numpy(predictor))}}, 0,
                    cfg.to_dict())
    task.pre_infer()
    n_params = sum(p.numel() for p in predictor.parameters())
    log(f"[18] seeded LJSpeech acoustic model: {n_params / 1e6:.1f}M parameters (n_symbols {list(predictor.n_symbols)}) "
        f"over the stripped autoencoder -> {os.path.relpath(am_path, ROOT)}")

    rng = np.random.default_rng(seed)
    text = _lj_phones(rng, 64)  # ~330 frames: padded in the static bucket of 512
    wav_path = os.path.join(LJ_DIR, "synthesize_static.wav")
    from msmctts_tpu_torch import synthesize

    t0 = time.perf_counter()  # in process: phase 5 runs the CLI's own process
    synthesize.main(["-m", am_path, "--text", text, "-o", wav_path, "--static-frames", str(LJ_STATIC_FRAMES)])
    syn_s = time.perf_counter() - t0
    sr, pcm = wavfile.read(wav_path)
    tokens = np.array([[int(t)] for t in text.split()])
    task.static_max_frames = LJ_STATIC_FRAMES
    _reset_counts()
    want = task.predict({"text": tokens[None], "text_length": np.array([len(tokens)])})
    counts = _counts()
    task.static_max_frames = None
    want_wav = want["wav"][0]
    _check_wavs([want_wav], want["mel_length"], LJ_HOP, "LJSpeech predict")
    err = float(np.abs(pcm / 32767.0 - want_wav).max()) if pcm.shape == want_wav.shape else float("inf")
    log(f"[18] synthesize --static-frames {LJ_STATIC_FRAMES}, in process ({syn_s:.1f}s): "
        f"{pcm.shape[0]} samples at {sr} Hz vs predict ({int(want['mel_length'][0])} frames, launches "
        f"{counts}): max abs err {err:.3g}")
    if sr != LJ_SR or not err <= AS_TOL or counts != {"vq_nearest": 4, "vq_nearest_stats": 0, "fused_resblock_layer": 36}:
        raise AssertionError(f"synthesize --static-frames vs predict: sr {sr}, err {err}, launches {counts}")

    # the daemon at batch 8 under the load generator, both as subprocesses
    out_json = os.path.join(LJ_DIR, "load_test.json")
    builds_before = cuda_build.build_count()
    port = _free_port()
    res, load_s = _subprocess(
        "load_test", "msmctts_tpu_torch.tools.load_test", "--spawn", "--levels", *map(str, LJ_LOAD_LEVELS),
        "--requests", str(LJ_LOAD_REQUESTS), "--n-symbols", "256", "--sample-rate", str(LJ_SR), "--out", out_json,
        "--warmup-timeout", str(SERVE_TIMEOUT_S), "--", "-m", am_path, "--port", str(port),
        "--batch-size", str(LJ_SERVE_B), "--max-frames", str(SERVE_MAX_FRAMES), timeout=900)
    warm_line = [line for line in res.stdout.splitlines() if line.startswith("warmup:")]
    report = json.load(open(out_json))
    levels = report["levels"]
    for row in levels:
        w = row["server_window"]
        log(f"[18] load_test on {card}, {row['concurrency']} clients: {row['requests']} requests in {row['wall_s']} s, "
            f"{row['requests_per_s']} req/s, latency p50 / p95 / p99 {row['latency_s']['p50'] * 1e3:.1f} / "
            f"{row['latency_s']['p95'] * 1e3:.1f} / {row['latency_s']['p99'] * 1e3:.1f} ms, {row['client_errors']} "
            f"client errors; server: {w['batches']} batches, mean size {w['mean_batch_size']}, errors {w['errors']}, "
            f"cold shapes {w['cold_shapes']}, kernel builds {w['kernel_builds']}, task RTF {w['task_realtime_factor']}")
    stream = report["streaming"]
    log(f"[18] load_test streaming, {stream['requests']} sequential: time to first audio p50 / p95 / p99 "
        f"{stream['ttfa_s']['p50'] * 1e3:.1f} / {stream['ttfa_s']['p95'] * 1e3:.1f} / {stream['ttfa_s']['p99'] * 1e3:.1f} ms")
    log(f"[18] load_test ({load_s:.1f}s): cold_shapes_during_run {report['cold_shapes_during_run']}, "
        f"kernel_builds_during_run {report['kernel_builds_during_run']}; daemon {warm_line[0] if warm_line else '?'}")
    bad = [row["concurrency"] for row in levels
           if row["client_errors"] or row["server_window"]["errors"] or row["requests"] != LJ_LOAD_REQUESTS]
    if bad or report["cold_shapes_during_run"] or report["kernel_builds_during_run"] or \
            [row["concurrency"] for row in levels] != list(LJ_LOAD_LEVELS):
        raise AssertionError(f"load_test: levels with errors {bad}, report {json.dumps(report)[:2000]}")
    if not warm_line or not warm_line[0].rstrip().endswith("kernel builds 0)"):
        raise AssertionError(f"the daemon built kernels at startup or printed no warmup line: {warm_line}")
    if cuda_build.build_count() != builds_before:
        raise AssertionError("this process built a kernel during the load test")
    return {"strip_s": strip_s, "stripped_dtypes": dtypes, "am_params": n_params, "am_path": am_path,
            "synthesize_static_err": err, "synthesize_launches": counts,
            "frames": int(want["mel_length"][0]), "load_test": report, "load_test_s": load_s}


def phase_lj_daemon(gen, card, am_path, seed=1234):
    """(c) continued: the daemon at batch 8 as ``load_test`` drives it, as a
    subprocess under 16 clients, every request it serves held to the same
    request alone in the in-process engine, with client-clock latency
    percentiles of the blocking ones; then, the daemon stopped, both kernels
    against their plain versions at its largest warm shapes (bucket 512:
    kernel 1 on the inputs of a served batch, kernel 5 at its 36 layers)."""
    import threading

    from msmctts_tpu_torch.ops import cuda_build
    from msmctts_tpu_torch.serving import BatchingEngine
    from msmctts_tpu_torch.tools.load_test import percentiles

    t_start = time.perf_counter()
    # the daemon starts first: its start overlaps the holds and the in-process references
    proc, lines, _ = _start_daemon("-m", am_path, "--port", "0", "--batch-size", str(LJ_SERVE_B), "--max-frames",
                                   str(SERVE_MAX_FRAMES))
    task = _load_tts_task(am_path, "cuda")
    eng = BatchingEngine(task, sample_rate=task.samplerate, batch_size=LJ_SERVE_B, window_ms=0.0,
                         max_frames=SERVE_MAX_FRAMES, stream_chunk_frames=SERVE_CHUNK)
    ae = task.networks["autoencoder"]
    F, L = SERVE_MAX_FRAMES, eng.text_length
    # a full batch at the largest frame bucket, as the engine pads it and as its warmup forces it
    batch = {"text": eng._warmup_text(L), "text_length": np.full((LJ_SERVE_B,), L, np.int32),
             "dur": eng._forced_durations(L, F - task.frame_margin)}
    task.predict(batch)
    _reset_counts()
    snaps = _snap_rows(ae, lambda: task.predict(batch))
    counts = _counts()
    want_n = [LJ_SERVE_B * F // s for s in task.networks["predictor"].n_pred_scale]  # [4, 1]: N = 8F/4, 8F
    if [s["x"].shape[0] for s in snaps] != want_n or \
            counts != {"vq_nearest": 4, "vq_nearest_stats": 0, "fused_resblock_layer": 36}:
        raise AssertionError(f"daemon batch at bucket {F}: snaps of N {[s['x'].shape[0] for s in snaps]}, launches {counts}")

    rng = np.random.default_rng(seed + 4)
    texts = [_lj_phones(rng, int(n)) for n in rng.integers(24, 97, LJ_DAEMON_TEXTS)]
    requests = [(texts[i % len(texts)], i % 8 == 7) for i in range(LJ_DAEMON_REQUESTS)]
    eng.start(warmup={})
    try:
        alone = {t: eng.synthesize(t, timeout=SERVE_TIMEOUT_S) for t in texts}
    finally:
        eng.stop()
    builds_before = cuda_build.build_count()
    try:
        warm_line = _wait_for_line(lines, "warmup:", proc, SERVE_TIMEOUT_S, "[18]")
        port = int(_wait_for_line(lines, "serving on", proc, 60, "[18]").rsplit(":", 1)[1])
        before = json.loads(_http(port, "GET", "/stats")[1])
        results = [None] * len(requests)

        def client(worker):
            for i in range(worker, len(requests), LJ_DAEMON_CLIENTS):
                t, stream = requests[i]
                results[i] = _http(port, "POST", "/synthesize", {"text": t, "stream": stream})

        threads = [threading.Thread(target=client, args=(w,)) for w in range(LJ_DAEMON_CLIENTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(SERVE_TIMEOUT_S)
        load_s = time.perf_counter() - t0
        if any(r is None for r in results):
            raise AssertionError("the LJSpeech daemon's load did not finish")
        stats = json.loads(_http(port, "GET", "/stats")[1])
        if proc.poll() is not None:
            raise AssertionError(f"the LJSpeech daemon died with {proc.returncode}")
    finally:
        _stop(proc)
    # the kernels' times at the daemon's largest warm shape, with the card to this process again
    snap_rows = _hold_snaps(snaps, f"LJSpeech daemon batch (B={LJ_SERVE_B}, bucket {F})", "[18]")
    layers = _hold_window_layers(gen, F, LJ_SERVE_B, stages=_mrf_stages(ae.decoder_config))
    log(f"[18] fused_resblock_layer at the daemon's 36 layers (B={LJ_SERVE_B}, bucket {F}: "
        f"{[(s['C'], s['T']) for s in layers['shapes']]}) on {card}: max abs err {layers['max_abs_err']:.3g}, per decode "
        f"{layers['ms']:.3f} ms kernel, {layers['plain_ms']:.3f} ms plain, bound {layers['bound_ms']:.3f} ms")
    worst, audio_s = 0.0, 0.0
    for (t, stream), (status, data, _, _) in zip(requests, results):
        if status != 200:
            raise AssertionError(f"LJSpeech daemon, {len(t.split())} phones (stream {stream}): {status} {data[:300]!r}")
        pcm = _pcm(data, stream) / 32767.0
        if pcm.shape != alone[t].shape or not np.abs(pcm).max() > 1e-3:
            raise AssertionError(f"LJSpeech daemon: {pcm.shape} samples, in-process {alone[t].shape} (stream {stream})")
        worst = max(worst, float(np.abs(pcm - alone[t]).max()))
        audio_s += pcm.shape[0] / LJ_SR
    blocking = [r[3] for (_, s), r in zip(requests, results) if not s]
    first = [r[2] for (_, s), r in zip(requests, results) if s]
    lat, ttfa = percentiles(blocking), percentiles(first)
    slowest = max((i for i, (_, s) in enumerate(requests) if not s), key=lambda i: results[i][3])
    batches = stats["batches"] - before["batches"]
    window = {"batches": batches, "requests": stats["requests"] - before["requests"],
              "errors": stats["errors"], "cold_shapes": stats["cold_shapes"], "kernel_builds": stats["kernel_builds"]}
    log(f"[18] LJSpeech daemon on {card}, batch {LJ_SERVE_B}, {LJ_DAEMON_CLIENTS} clients: {len(requests)} requests "
        f"({len(first)} streamed) over {len(texts)} texts in {load_s:.2f} s ({len(requests) / load_s:.1f} req/s, "
        f"{audio_s:.1f} s of audio), {batches} batches; blocking latency (client clock, {len(blocking)} requests) "
        f"p50 / p95 / p99 {lat['p50'] * 1e3:.1f} / {lat['p95'] * 1e3:.1f} / {lat['p99'] * 1e3:.1f} ms, max "
        f"{max(blocking) * 1e3:.1f} ms (request {slowest} of client {slowest % LJ_DAEMON_CLIENTS}); streamed time to first audio p50 / p99 {ttfa['p50'] * 1e3:.1f} / "
        f"{ttfa['p99'] * 1e3:.1f} ms; served vs in-process engine max abs err {worst:.3g}; /stats {json.dumps(window)}")
    if worst > AS_TOL or stats["cold_shapes"] or stats["kernel_builds"] or stats["errors"] or batches < 1 \
            or not (stats["requests"] - before["requests"]) / batches > LJ_SERVE_B / 2:
        raise AssertionError(f"LJSpeech daemon under load: served vs in-process {worst}, /stats {stats}")
    if cuda_build.build_count() != builds_before:
        raise AssertionError("this process built a kernel while the LJSpeech daemon served")
    wall = time.perf_counter() - t_start
    log(f"[18] the daemon's holds and load {wall:.1f}s")
    return {"wall_s": wall, "slowest_request": slowest, "batch_launches": counts, "snap": snap_rows, "resblock": layers, "warmup_line": warm_line.strip(),
            "clients": LJ_DAEMON_CLIENTS, "requests": len(requests), "streamed": len(first), "load_s": load_s,
            "latency_s": lat, "latency_max_s": max(blocking), "ttfa_s": ttfa, "served_err": worst, "window": window}


def phase_lj_profile(card):
    """(d) ``python -m msmctts_tpu_torch.train --profile DIR`` on the LJSpeech
    autoencoder recipe (its warmup phase) for 15 steps over a corpus written
    here: the trace of steps 10-14 under DIR names kernel 2's kernels."""
    import shutil

    import yaml

    d = os.path.join(LJ_DIR, "corpus")
    _write_mel_corpus(d, n_utts=TRAIN_B, seed=184, frameshift=LJ_HOP, sr=LJ_SR)
    cfg = _recipe_config(LJ_AE_YAML, os.path.join(LJ_DIR, "ckpt_cli"))
    shutil.rmtree(cfg["save_checkpoint_dir"], ignore_errors=True)
    cfg["dataloader"] = {"batch_size": TRAIN_B, "num_workers": 2}
    cfg.dataset["id_list"] = os.path.join(d, "train.list")
    cfg.dataset["feature_path"] = [os.path.join(d, "mel", "{}.npy"), os.path.join(d, "wav", "{}.wav")]
    cfg_path = os.path.join(LJ_DIR, "ae_cli.yaml")
    with open(cfg_path, "w") as fh:
        yaml.safe_dump(cfg.to_dict(), fh)
    prof_dir = os.path.join(LJ_DIR, "profile")
    shutil.rmtree(prof_dir, ignore_errors=True)
    from msmctts_tpu_torch import train

    res, wall = _in_process(train.main, "-c", cfg_path, "--max-steps", str(LJ_PROFILE_STEPS), "--log-every", "5",
                            "--profile", prof_dir)
    traces = sorted(os.listdir(prof_dir)) if os.path.isdir(prof_dir) else []
    if traces != ["steps_10-14_rank0.json"]:
        raise AssertionError(f"train --profile wrote {traces}:\n{res.stdout[-3000:]}")
    path = os.path.join(prof_dir, traces[0])
    text = open(path).read()
    events = json.loads(text)["traceEvents"]
    kernels = {}
    for ev in events:
        if ev.get("cat") == "kernel":
            kernels[ev["name"]] = kernels.get(ev["name"], 0) + 1
    vq_stats = {k: n for k, n in kernels.items() if "vq_stats" in k}
    last = [line for line in res.stdout.splitlines() if line.startswith("step ") or "] step " in line]
    log(f"[18] train --profile, LJSpeech recipe, {LJ_PROFILE_STEPS} warmup steps at batch {TRAIN_B} ({wall:.1f}s): "
        f"{os.path.relpath(path, ROOT)} {os.path.getsize(path) / 1e6:.1f} MB, {len(events)} events, "
        f"{sum(kernels.values())} kernel launches, kernel 2's: {vq_stats}; {last[-1].strip() if last else ''}")
    if not vq_stats or sum(vq_stats.values()) < 2 * 5:
        raise AssertionError(f"the profile names no statistics kernel over its 5 steps: {sorted(kernels)[:20]}")
    return {"wall_s": wall, "trace": os.path.relpath(path, ROOT), "trace_mb": os.path.getsize(path) / 1e6,
            "events": len(events), "kernel_launches": sum(kernels.values()), "vq_stats_kernels": vq_stats}


def _reference_names(sd):
    """The port's one [H, d, K] codebook tensor per stage -> the reference's
    per-head buffers (``quantizers.<h>.embed`` ...)."""
    out = {}
    for k, v in sd.items():
        stage, _, name = k.rpartition(".")
        if ".quantizer.quantizer." in k and name in ("embed", "cluster_size", "embed_avg"):
            for h in range(v.shape[0]):
                out[f"{stage}.quantizers.{h}.{name}"] = v[h].clone()
        else:
            out[k] = v
    return out


def phase_lj_convert(card, seed=1234):
    """(e) A reference-named checkpoint (``{'model': task.state_dict()}``) of
    seeded ``train()``-mode LJSpeech modules through
    ``tools.convert_torch_checkpoint``; ``infer`` of the result against
    ``predict`` of the original modules."""
    import shutil

    import yaml
    from scipy.io import wavfile

    from msmctts_tpu_torch.data.datasets import TEXT_BUCKETS, bucket_length
    from msmctts_tpu_torch.tasks import build_task
    from msmctts_tpu_torch.weights import init_random

    ae = build_task(_recipe_config(LJ_AE_YAML), device="cuda").networks["autoencoder"]
    init_random(ae, seed + 1)
    _audible(ae.decoder, seed + 1)
    am_cfg = _recipe_config(LJ_AM_YAML)
    task = build_task(am_cfg, device="cuda")
    predictor = task.networks["predictor"]
    init_random(predictor, seed + 2)
    predictor.bias_durations(4.2)
    ae.train()  # as a training run's snapshot holds them: live weight norm
    predictor.train()
    sd = {f"autoencoder.{k}": v.detach().cpu() for k, v in ae.state_dict().items()}
    sd.update({f"predictor.{k}": v.detach().cpu() for k, v in predictor.state_dict().items()})
    sd = _reference_names(sd)
    ref_path = os.path.join(LJ_DIR, "reference_model_800000")
    torch.save({"model": sd, "iteration": 800000}, ref_path)
    converted = os.path.join(LJ_DIR, "converted", "model_800000")
    shutil.rmtree(os.path.dirname(converted), ignore_errors=True)
    cfg = am_cfg.to_dict()
    cfg["task"]["autoencoder"]["_checkpoint"] = converted  # the converted file holds both networks
    cfg["task"]["autoencoder"]["_config"] = LJ_AE_YAML
    cfg_path = os.path.join(LJ_DIR, "converted_am.yaml")
    with open(cfg_path, "w") as fh:
        yaml.safe_dump(cfg, fh)
    from msmctts_tpu_torch.tools import convert_torch_checkpoint

    res, conv_s = _in_process(convert_torch_checkpoint.main, "--torch", ref_path, "--config", cfg_path, "--out", converted)
    log(f"[18] convert_torch_checkpoint ({conv_s:.1f}s, {len(sd)} reference tensors, per-head codebooks): "
        f"{res.stdout.strip()}")

    # predict from the original modules, in eval(), on the texts of a test list
    ae.eval()
    predictor.eval()
    task.networks["autoencoder"] = ae
    task._loaded_modules = True
    rng = np.random.default_rng(seed + 3)
    texts = {f"lj{i:03d}": _lj_phones(rng, n) for i, n in enumerate((31, 64, 97))}
    test_list = os.path.join(LJ_DIR, "converted_test.yaml")
    with open(test_list, "w") as fh:
        yaml.safe_dump({u: {"text": t} for u, t in texts.items()}, fh)
    out_dir = os.path.join(LJ_DIR, "converted_infer")
    shutil.rmtree(out_dir, ignore_errors=True)
    from msmctts_tpu_torch import infer

    t0 = time.perf_counter()  # in process: phases 13 and 16 run the CLI's own process
    infer.main(["-m", converted, "-t", test_list, "-o", out_dir])
    infer_s = time.perf_counter() - t0
    worst, frames = 0.0, {}
    for uid, t in texts.items():
        # padded to its text bucket, as the test list's loader pads it: the duration
        # predictor's convs reach the last phones from the padding, in both packages
        n = len(t.split())
        tokens = np.zeros((1, bucket_length(n, TEXT_BUCKETS), 1), np.int64)
        tokens[0, :n, 0] = [int(v) for v in t.split()]
        out = task.predict({"text": tokens, "text_length": np.array([n])})
        _check_wavs(out["wav"], out["mel_length"], LJ_HOP, "LJSpeech predict of the original modules")
        want = out["wav"][0]
        sr, pcm = wavfile.read(os.path.join(out_dir, f"{uid}_wav.wav"))
        if sr != LJ_SR or pcm.shape != want.shape:
            raise AssertionError(f"infer of the converted checkpoint, {uid}: {pcm.shape} at {sr} Hz vs {want.shape}")
        worst = max(worst, float(np.abs(pcm / 32767.0 - want).max()))
        frames[uid] = want.shape[0] // LJ_HOP
    log(f"[18] infer of the converted checkpoint ({infer_s:.1f}s) vs predict of the original modules on {card}: "
        f"{len(texts)} utterances of {list(frames.values())} frames, max abs err {worst:.3g}")
    if not worst <= AS_TOL:
        raise AssertionError(f"infer of the converted checkpoint vs predict of the original modules: {worst}")
    return {"convert_s": conv_s, "infer_s": infer_s, "max_abs_err": worst, "frames": frames}


def phase_ljspeech(gen, card):
    """Phase 18, (a) to (e)."""
    import shutil

    t0 = time.perf_counter()
    shutil.rmtree(LJ_DIR, ignore_errors=True)
    os.makedirs(LJ_DIR)
    result = {"analysis_synthesis": _seeded_analysis_synthesis(gen, card, LJ_AE_YAML, "[18]", "LJSpeech", 18,
                                                              "HifiGANGenerator")}
    rng = np.random.default_rng(1234)
    lengths = rng.integers(200, TRAIN_FRAMES + 1, size=TRAIN_B)
    lengths[0] = TRAIN_FRAMES

    def make():
        # from the fixture's encoder, quantizer and codebook: a seeded codebook's codewords
        # can pass float16's range, which (c) strips to
        trainer = _seeded_trainer(_recipe_config(LJ_AE_YAML, os.path.join(LJ_DIR, "ckpt_ae"), warmup_steps=2), "cuda")
        _from_fixture(trainer)
        return trainer

    result["training"] = _recipe_training(make, _train_batch(rng, lengths, TRAIN_FRAMES, frameshift=LJ_HOP), lengths,
                                          card, "[18]", "LJSpeech")
    result["step_card_vs_cpu"] = _step_card_vs_cpu(LJ_AE_YAML, [64, 56], LJ_HOP, 181, "[18]", "LJSpeech")
    result["tools"] = phase_lj_tools(card, result["training"]["checkpoint"])
    result["daemon"] = phase_lj_daemon(gen, card, result["tools"]["am_path"])
    result["profile"] = phase_lj_profile(card)
    result["convert"] = phase_lj_convert(card)
    result["phase_s"] = time.perf_counter() - t0
    log(f"[18] LJSpeech phase {result['phase_s']:.1f}s")
    return result


# ------------------------------------------------------------- bf16 mixed precision
# Phase 19: ``precision: bfloat16`` (the JAX package's policy, parallel/precision.py)
# through the AE GAN step, the AM step and inference at the CSMSC recipes' full width.
BF16_STEP_TOL = {"loss_rtol": 1e-2, "codebook_atol": 1e-3}
BF16_SERVE_FRAMES = 256  # the bf16 daemon's frame cap (fewer warmup shapes than phase 13's)
PRODUCT_WORDS = ("conv", "gemm", "xmma", "cudnn", "cutlass", "wgrad", "dgrad", "fprop", "s16816", "s1688", "nvjet")


def _product_dtype(name):
    """The operand dtype a cuDNN / cuBLAS product kernel's name states, or
    None for a kernel that is not a convolution or matrix product (cuDNN's
    layout transposes and PyTorch's elementwise and reduction kernels)."""
    n = name.lower()
    if not any(w in n for w in PRODUCT_WORDS) or any(w in n for w in ("elementwise", "reduce", "nchwtonhwc", "nhwctonchw")):
        return None
    if "bf16" in n or "bfloat16" in n:
        return "bf16"
    if "tf32" in n:
        return "tf32"
    if "f16" in n or "half" in n:
        return "fp16"
    if "f32" in n or "float" in n or "sgemm" in n:
        return "fp32"
    return "unstated"  # a product whose name gives no dtype


def _by_product_dtype(prof, tag, what):
    """{dtype: device ms} over a profile's convolution and matrix-product
    kernels, with the busy ms of everything else as "other"; logs the
    longest product kernels that are not fp32."""
    split = {}
    for r in prof["kernels"]:
        key = _product_dtype(r["name"]) or "other"
        split[key] = split.get(key, 0.0) + r["device_ms"]
    for r in [r for r in prof["kernels"] if _product_dtype(r["name"]) not in (None, "fp32")][:6]:
        log(f"{tag} {what}, a {_product_dtype(r['name'])} product: {r['device_ms']:.3f} ms x{r['count']} {r['name']}")
    return split


def _fp32_state(modules, what):
    """Masters and buffers (codebooks, BN statistics) stay fp32 under bf16."""
    for module in modules:
        for name, t in list(module.named_parameters()) + list(module.named_buffers()):
            if t is not None and t.is_floating_point() and t.dtype != torch.float32:
                raise AssertionError(f"{what}: {name} is {t.dtype}, the masters and buffers stay fp32")


def _turns(steps):
    """Warm step times of two trainers in turns (fp32, bf16, bf16, fp32;
    two steps a turn), ``steps``: {precision: callable of one step}.
    -> {precision: [ms]}."""
    times = {k: [] for k in steps}
    for name in ("float32", "bfloat16", "bfloat16", "float32"):
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps[name]()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return times


def phase_bf16_vqgan(card):
    """(a) 2 warmup + 2 GAN steps of the CSMSC AE recipe under bf16."""
    from msmctts_tpu_torch.data.loader import to_device
    from msmctts_tpu_torch.training.base_trainer import metrics_to_host

    batch = to_device(_training_batch()[0], "cuda")
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trainer = _build_trainer("cuda", warmup_steps=2, precision="bfloat16")
    ae, disc = trainer.ae, trainer.disc
    if trainer.compute_dtype != torch.bfloat16:
        raise AssertionError(f"the trainer computes in {trainer.compute_dtype}")
    steps, stats = [], None
    for it in range(1, 5):
        phase = "warmup" if it <= trainer.warmup_steps else "gan"
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        if it == 3:  # the first GAN step's statistics-kernel inputs, as the path gave them
            holder = {}
            stats = _stats_rows(ae, lambda: holder.update(m=trainer.train_step(batch, it)))
            metrics = holder["m"]
        else:
            metrics = trainer.train_step(batch, it)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts, host = _counts(), metrics_to_host(metrics)
        bad = [k for k, v in host.items() if not np.isfinite(v)]
        if bad or counts != {"vq_nearest": 0, "vq_nearest_stats": 2, "fused_resblock_layer": 0}:
            raise AssertionError(f"bf16 step {it}: non-finite {bad}, launches {counts}")
        steps.append({"iteration": it, "phase": phase, "ms": ms, "metrics": host})
        log(f"[19] bf16 AE step {it} ({phase}): {ms:.1f} ms, launches {counts}, "
            f"{ {k: round(host[k], 4) for k in ('g_loss', 'vq_loss', 'frame_loss', 'd_loss', 'stft_loss') if k in host} }")
    peak = {"bfloat16": (torch.cuda.max_memory_allocated() - base) / 2**30}
    _fp32_state((ae, disc), "bf16 AE step")
    held = _hold_stats(stats, "bf16 GAN step", tag="[19]")

    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fp32 = _build_trainer("cuda", warmup_steps=2)
    fp32.train_step(batch, 1), fp32.train_step(batch, 30)
    peak["float32"] = (torch.cuda.max_memory_allocated() - base) / 2**30  # trainer + a warmup and a GAN step
    run = {"float32": fp32, "bfloat16": trainer}
    warm = {ph: _turns({k: (lambda t=t, it=it: t.train_step(batch, it)) for k, t in run.items()})
            for ph, it in (("warmup", 1), ("gan", 31))}
    profiles = {k: profile_call(lambda t=t: t.train_step(batch, 40), "[19]", f"{k} GAN step", shown=3)
                for k, t in run.items()}
    result = {"steps": steps, "peak_above_start_gib": peak, "stats": held,
              "warm_ms": {ph: {k: statistics.median(v) for k, v in w.items()} for ph, w in warm.items()},
              "warm_runs_ms": warm,
              "profile": {k: {"wall_ms": p["wall_ms"], "busy_ms": p["busy_ms"],
                              "products_ms": _by_product_dtype(p, "[19]", f"{k} GAN step")} for k, p in profiles.items()}}
    log(f"[19] AE steps on {card}, warm median in turns: warmup fp32 {result['warm_ms']['warmup']['float32']:.1f} / bf16 "
        f"{result['warm_ms']['warmup']['bfloat16']:.1f} ms, GAN fp32 {result['warm_ms']['gan']['float32']:.1f} / bf16 "
        f"{result['warm_ms']['gan']['bfloat16']:.1f} ms; peak memory above the start, trainer and steps, fp32 "
        f"{peak['float32']:.2f} / bf16 {peak['bfloat16']:.2f} GiB; "
        f"device ms by product dtype {json.dumps({k: {d: round(v, 2) for d, v in p['products_ms'].items()} for k, p in result['profile'].items()})}")
    del trainer, fp32, run
    return result


def phase_bf16_am(card):
    """(b) the CSMSC AM step at batch 64, bucket 768, under bf16."""
    from msmctts_tpu_torch.data.loader import to_device
    from msmctts_tpu_torch.ops import vq
    from msmctts_tpu_torch.training.base_trainer import metrics_to_host

    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trainer = _build_am_trainer("cuda", precision="bfloat16")
    predictor, ae = trainer.predictor, trainer.frozen_autoencoder()
    if not all(p.dtype == torch.bfloat16 for p in ae.parameters()):
        raise AssertionError("the bf16 AM trainer's teacher does not hold bf16 parameters")
    n_symbols = list(trainer.config.task["predictor"]["n_symbols"])
    batch = to_device(_am_batch(np.random.default_rng(1234), n_symbols, AM_B, AM_TEXT, AM_FRAMES, AM_PHONES, AM_LENGTHS),
                      "cuda")
    snaps = []
    pre = [q.register_forward_pre_hook(lambda m, a: snaps.append({"x": a[0].detach().reshape(-1, m.n_head, m.sub_dim)}))
           for q in ae.quantizer.quantizer]
    post = [q.register_forward_hook(lambda m, a, o: snaps[-1].update(idx=o[2].reshape(-1, m.n_head), embed=m.embed))
            for q in ae.quantizer.quantizer]
    steps = []
    for it in range(1, 3):
        snaps.clear()
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        host = metrics_to_host(trainer.train_step(batch, it))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = _counts()
        if any(not np.isfinite(v) for v in host.values()) or counts != {"vq_nearest": 2, "vq_nearest_stats": 0,
                                                                          "fused_resblock_layer": 0}:
            raise AssertionError(f"bf16 AM step {it}: {host}, launches {counts}")
        steps.append({"iteration": it, "ms": ms, "metrics": host})
        log(f"[19] bf16 AM step {it}: {ms:.1f} ms, launches {counts}, {json.dumps({k: round(v, 4) for k, v in host.items()})}")
    peak = {"bfloat16": (torch.cuda.max_memory_allocated() - base) / 2**30}
    for h in pre + post:
        h.remove()
    _fp32_state((predictor,), "bf16 AM step")
    snap_rows = []
    for stage, s in enumerate(snaps):  # the teacher's snaps of the last step, kernel vs plain
        x, e = s["x"].contiguous(), s["embed"]
        if x.dtype != torch.float32:
            raise AssertionError(f"the teacher's stage {stage} snaps {x.dtype} rows")
        idx, quant = vq.vq_nearest(x, e)
        ref_idx, ref_quant = vq.vq_nearest_plain(x, e)
        if not torch.equal(idx, s["idx"]):
            raise AssertionError(f"bf16 AM teacher stage {stage}: the step's indices differ from a second launch")
        err, mismatches = _hold_snap(f"bf16 AM teacher snap stage {stage}", x, e, idx, quant, ref_idx, ref_quant)
        snap_rows.append({"stage": stage, "N": x.shape[0], "index_mismatches": mismatches, "max_abs_err": err})
    log(f"[19] bf16 AM teacher snaps vs plain: {json.dumps(snap_rows)}")

    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fp32 = _build_am_trainer("cuda")
    fp32.train_step(batch, 1)
    peak["float32"] = (torch.cuda.max_memory_allocated() - base) / 2**30
    run = {"float32": fp32, "bfloat16": trainer}
    warm = _turns({k: (lambda t=t: t.train_step(batch, 5)) for k, t in run.items()})
    profiles = {k: profile_call(lambda t=t: t.train_step(batch, 6), "[19]", f"{k} AM step", shown=3)
                for k, t in run.items()}
    result = {"steps": steps, "peak_above_start_gib": peak, "snap": snap_rows,
              "warm_ms": {k: statistics.median(v) for k, v in warm.items()}, "warm_runs_ms": warm,
              "profile": {k: {"wall_ms": p["wall_ms"], "busy_ms": p["busy_ms"], "busy_share": p["busy_ms"] / p["wall_ms"],
                              "products_ms": _by_product_dtype(p, "[19]", f"{k} AM step")} for k, p in profiles.items()}}
    log(f"[19] AM step on {card}, warm median in turns: fp32 {result['warm_ms']['float32']:.1f} / bf16 "
        f"{result['warm_ms']['bfloat16']:.1f} ms; peak memory above the start, trainer and steps, fp32 "
        f"{peak['float32']:.2f} / bf16 {peak['bfloat16']:.2f} GiB; busy "
        f"{ {k: round(p['busy_share'], 3) for k, p in result['profile'].items()} }; device ms by product dtype "
        f"{json.dumps({k: {d: round(v, 2) for d, v in p['products_ms'].items()} for k, p in result['profile'].items()})}")
    del trainer, fp32, run
    return result


class _Recorder:
    """Wrap a module-level function; keep the inputs of every call."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []
        self.fn = getattr(module, name)

    def __enter__(self):
        def wrapped(*args):
            self.calls.append([a.detach().clone() if torch.is_tensor(a) else a for a in args])
            return self.fn(*args)

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def phase_bf16_inference(card, am_path, reference):
    """(c) predict at batch 4 and a few daemon requests under bf16."""
    import threading

    from msmctts_tpu_torch.models import hifigan, predictor as predictor_mod, quantizer
    from msmctts_tpu_torch.ops import cuda_build, resblock as rb, vq
    from msmctts_tpu_torch.config import Config
    from msmctts_tpu_torch.serving import BatchingEngine
    from msmctts_tpu_torch.tasks import build_task
    from msmctts_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    ck = load_checkpoint(am_path)
    ck["config"]["precision"] = "bfloat16"
    bf16_path = os.path.join(SMOKE_DIR, "am_seeded_bf16.ckpt")
    save_checkpoint(bf16_path, ck["state"], 0, ck["config"])
    task = _load_tts_task(bf16_path, "cuda")
    fp32 = _load_tts_task(am_path, "cuda")
    for name, module in task.networks.items():
        if not all(p.dtype == torch.bfloat16 for p in module.parameters()):
            raise AssertionError(f"the bf16 task's {name} holds parameters in another dtype")
    for q in task.networks["autoencoder"].quantizer.quantizer:  # buffers, not params: fp32 as JAX's codebook collection
        if {q.embed.dtype, q.cluster_size.dtype, q.embed_avg.dtype} != {torch.float32}:
            raise AssertionError("the bf16 task's codebooks are not fp32")
    # the trained fixture's analysis-synthesis, bf16 against fp32: the decoder's
    # error on trained weights, apart from any codeword the predictor changes
    fixture = load_checkpoint(FIXTURE)
    ae_tasks = {}
    for name in ("float32", "bfloat16"):
        cfg = Config(fixture["config"])
        cfg["precision"] = name
        ae_tasks[name] = build_task(cfg, device="cuda")
        ae_tasks[name].load_variables(fixture["state"])
    rng = np.random.default_rng(4)
    lengths = np.array(ISTFT_LENGTHS)
    mel = rng.normal(size=(len(lengths), FRAMES, 80)).astype(np.float32) * 0.5
    mel *= (np.arange(FRAMES)[None, :] < lengths[:, None])[..., None]
    as_batch = {"mel": mel, "mel_length": lengths}
    as_out = {k: t.analysis_synthesis(as_batch)["wav"] for k, t in ae_tasks.items()}
    as_rel = [_rel_l2(a, b) for a, b in zip(as_out["bfloat16"], as_out["float32"])]
    with torch.inference_mode():
        mel_t, len_t = torch.as_tensor(mel, device="cuda"), torch.as_tensor(lengths, device="cuda")
        q = {k: t.networks["autoencoder"].analysis(mel_t, len_t) for k, t in ae_tasks.items()}
    as_flips = as_codes = 0
    for a, b, n in zip(q["bfloat16"]["quantizer_indices"], q["float32"]["quantizer_indices"],
                       q["float32"]["quantizer_lengths"]):
        in_length = (torch.arange(a.shape[1], device="cuda")[None] < n[:, None])[..., None].expand_as(a)
        as_flips += int(((a != b) & in_length).sum())
        as_codes += int(in_length.sum())
    log(f"[19] the fixture's analysis-synthesis B=4 frames {lengths.tolist()}, bf16 vs fp32: relative L2 "
        f"{[round(r, 5) for r in as_rel]}, {as_flips} of {as_codes} codeword indices differ")
    del ae_tasks, q

    batch = reference["batch"]
    want = reference["out"]  # phase 5's fp32 predict of this batch

    # predicted durations: flips against fp32 with their rounding margins
    dur_bf16 = task.predict(batch)["duration"]
    with torch.inference_mode():
        text = torch.as_tensor(batch["text"], device="cuda").long()
        tl = torch.as_tensor(batch["text_length"], device="cuda").long()
        pred = fp32.networks["predictor"]
        x, mask = pred._encode(text, tl)
        raw = pred.upsampler.duration_predictor(x, mask).float().cpu().numpy()
    valid = np.arange(raw.shape[1])[None] < np.asarray(batch["text_length"])[:, None]
    flips = (dur_bf16 != want["duration"]) & valid
    margins = np.abs(np.abs(raw - np.floor(raw) - 0.5))[flips].tolist()
    log(f"[19] bf16 predict, predicted durations: {int(flips.sum())} of {int(valid.sum())} phones round otherwise than "
        f"fp32's, at fp32 distances {[round(m, 4) for m in margins]} from the rounding boundary")

    # forced to fp32's durations: the decode of the same frames, launches, kernels vs plain
    forced = {**batch, "dur": np.asarray(want["duration"], np.float32)}
    task.predict(forced)
    torch.cuda.synchronize()
    _reset_counts()
    with _Recorder(predictor_mod, "vq_nearest_sharded") as p_rec, _Recorder(quantizer, "vq_nearest_sharded") as q_rec, \
            _Recorder(hifigan, "fused_resblock_layer") as rb_rec:
        got = task.predict(forced)
    torch.cuda.synchronize()
    counts = _counts()
    if counts != {"vq_nearest": 4, "vq_nearest_stats": 0, "fused_resblock_layer": 36}:
        raise AssertionError(f"bf16 predict launches {counts}")
    ratio = task.networks["autoencoder"].frameshift_ratio
    _check_wavs(got["wav"], got["mel_length"], ratio, "bf16 predict")
    rel = [_rel_l2(a, b) for a, b in zip(got["wav"], want["wav"])]
    code_flips = sum(int((a != b).any(-1).sum()) for a, b in zip(got["embedding"], want["embedding"]))
    snap_rows = []
    for x, e in [c[:2] for c in p_rec.calls + q_rec.calls]:
        if x.dtype != torch.float32:
            raise AssertionError(f"a bf16 predict snap got {x.dtype} rows")
        idx, quant = vq.vq_nearest(x, e)
        ref_idx, ref_quant = vq.vq_nearest_plain(x, e)
        err, mism = _hold_snap(f"bf16 predict snap N={x.shape[0]}", x, e, idx, quant, ref_idx, ref_quant)
        snap_rows.append({"N": x.shape[0], "max_abs_err": err, "index_mismatches": mism})
    rb_worst, rb_shapes = 0.0, set()
    for x, w1, b1, w2, b2, d, prepared in rb_rec.calls:
        if x.dtype != torch.float32:
            raise AssertionError(f"the MRF kernel got {x.dtype} activations")
        rb_worst = max(rb_worst, _hold_resblock(rb, f"bf16 predict C={x.shape[2]} T={x.shape[1]} d={d}",
                                                x, w1, b1, w2, b2, d, prepared))
        rb_shapes.add((x.shape[0], x.shape[1], x.shape[2]))
    rb_rec.calls.clear()
    warm = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        task.predict(forced)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
    log(f"[19] bf16 predict B=4 (fp32's durations): launches {counts}, relative L2 vs fp32 predict "
        f"{[round(r, 5) for r in rel]}, {code_flips} frames with another codeword; snaps vs plain {json.dumps(snap_rows)}; "
        f"36 MRF layers vs plain max abs err {rb_worst:.3g} at {sorted(rb_shapes)}; warm {statistics.median(warm):.1f} ms")

    # the daemon from a checkpoint whose config asks for bf16, against an in-process bf16 engine
    rng = np.random.default_rng(19)
    n_symbols = list(task.networks["predictor"].n_symbols)
    texts = [_phone_string(_text(rng, [int(n)], n_symbols, int(n))[0]) for n in (24, 41, 57)]
    eng = BatchingEngine(task, sample_rate=task.samplerate, batch_size=SERVE_B, window_ms=0.0,
                         max_frames=BF16_SERVE_FRAMES, stream_chunk_frames=SERVE_CHUNK)
    eng.start()
    try:
        alone = {t: eng.synthesize(t, timeout=SERVE_TIMEOUT_S) for t in texts}
    finally:
        eng.stop()
    # the daemon's engine and HTTP handler in this process (phases 13, 16 and 18
    # run the daemon's own process): serve's build_engine over the bf16 checkpoint
    import argparse
    from http.server import ThreadingHTTPServer

    from msmctts_tpu_torch import serve

    builds_before = cuda_build.build_count()
    t0 = time.perf_counter()
    args = argparse.Namespace(artifact=None, model=bf16_path, config=None, device="cuda", int8=False, static_frames=None,
                              sample_rate=None, batch_size=SERVE_B, window_ms=15.0, max_frames=BF16_SERVE_FRAMES,
                              max_queue=256, stream_chunk_frames=SERVE_CHUNK)
    served = serve.build_engine(args).start(warmup={"text_lengths": None, "include_streaming": None})
    ready = threading.Event()
    ready.set()
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(served, ready, SERVE_TIMEOUT_S))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        port = server.server_port
        ready_s = time.perf_counter() - t0
        log(f"[19] bf16 engine: warmup ran {len(served._warm_shapes)} serving shapes in {served.warmup_s:.3f}s "
            f"(streaming={'warm' if served._streaming_warm else 'off'}, kernel builds {cuda_build.build_count() - builds_before})")
        requests = [(t, False) for t in texts] + [(texts[-1], True)]
        results = [None] * len(requests)

        def client(i):
            results[i] = _http(port, "POST", "/synthesize", {"text": requests[i][0], "stream": requests[i][1]})

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(requests))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(SERVE_TIMEOUT_S)
        status, data, _, _ = _http(port, "GET", "/stats")
        stats = json.loads(data)
    finally:
        server.shutdown()
        server.server_close()
        served.stop()
    served_err = 0.0
    for (t, stream), r in zip(requests, results):
        if r is None or r[0] != 200:
            raise AssertionError(f"bf16 daemon request ({len(t.split())} phones, stream {stream}): {r and r[:2]}")
        pcm = _pcm(r[1], stream) / 32767.0
        if pcm.shape != alone[t].shape:
            raise AssertionError(f"bf16 daemon: {pcm.shape} samples, in-process {alone[t].shape}")
        served_err = max(served_err, float(np.abs(pcm - alone[t]).max()))
    if stats["cold_shapes"] != 0 or stats["kernel_builds"] != 0 or stats["errors"] != 0 or served_err > AS_TOL:
        raise AssertionError(f"bf16 daemon: /stats {stats}, served vs in-process {served_err}")
    if cuda_build.build_count() != builds_before:
        raise AssertionError("this process built a kernel during the bf16 daemon's run")
    log(f"[19] bf16 daemon (in process) ready in {ready_s:.1f}s: {len(requests)} requests (1 streamed), served vs the bf16 engine "
        f"max abs err {served_err:.3g}; /stats cold_shapes {stats['cold_shapes']}, kernel_builds {stats['kernel_builds']}, "
        f"errors {stats['errors']}")
    del task, fp32
    return {"analysis_synthesis": {"frames": lengths.tolist(), "rel_l2_vs_fp32": as_rel, "index_flips": as_flips,
                                   "indices": as_codes},
            "duration_flips": int(flips.sum()), "phones": int(valid.sum()), "flip_margins": margins,
            "rel_l2_vs_fp32": rel, "codeword_frames_changed": code_flips, "launches": counts, "snap": snap_rows,
            "resblock_max_abs_err": rb_worst, "resblock_shapes": sorted(rb_shapes), "warm_ms": statistics.median(warm),
            "warm_runs_ms": warm, "daemon": {"ready_s": ready_s, "served_err": served_err, "stats": stats}}


def phase_bf16_card_vs_cpu():
    """(d) one bf16 step of each phase (AE warmup, AE GAN, AM) from equal
    state, card vs CPU: losses within ``BF16_STEP_TOL``; a teacher or
    quantizer index that differs must sit at a near-tie (``DP_TOL``)."""
    from msmctts_tpu_torch.data.loader import to_device
    from msmctts_tpu_torch.training.base_trainer import metrics_to_host

    rng = np.random.default_rng(7)
    batch = _train_batch(rng, [64, 48], 64)
    starts = np.array([11, 3])
    n_symbols = list(_am_config().task["predictor"]["n_symbols"])
    am_batch = _am_batch(np.random.default_rng(8), n_symbols, 2, 16, 64, (9, 16), (40, 60))
    out = {}
    for device in ("cuda", "cpu"):
        trainer = _build_trainer(device, warmup_steps=1, dropout=0.0, precision="bfloat16")
        rows = []  # per stage pass: (input rows, the codebook before its update, indices)
        hooks = [q.register_forward_pre_hook(lambda m, a: rows.append([a[0].detach().float().cpu(), m.embed.cpu().clone()]))
                 for q in trainer.ae.quantizer.quantizer]
        hooks += [q.register_forward_hook(lambda m, a, o: rows[-1].append(o[2].cpu()))
                  for q in trainer.ae.quantizer.quantizer]
        dev = to_device(batch, device)
        m1 = metrics_to_host(trainer.train_step(dev, 1))
        m2 = metrics_to_host(trainer.train_step(dev, 2, starts=torch.as_tensor(starts, device=device)))
        for h in hooks:
            h.remove()
        cb = [q.embed.cpu() for q in trainer.ae.quantizer.quantizer]
        del trainer
        am = _build_am_trainer(device, dropout=0.0, precision="bfloat16")
        m3 = metrics_to_host(am.train_step(to_device(am_batch, device), 1))
        del am
        out[device] = {"warmup": m1, "gan": m2, "am": m3, "rows": rows, "codebook": cb}
    worst, flips, gaps = 0.0, 0, []
    for phase in ("warmup", "gan", "am"):
        for k, want in out["cpu"][phase].items():
            got = out["cuda"][phase][k]
            rel = abs(got - want) / max(abs(want), 1e-3)
            worst = max(worst, rel)
            if rel > BF16_STEP_TOL["loss_rtol"]:
                raise AssertionError(f"bf16 {phase} step, {k}: card {got} vs CPU {want}")
    for (x, e, idx), (_, _, ref_idx) in zip(out["cuda"]["rows"], out["cpu"]["rows"]):
        H = idx.shape[-1]
        x, idx, ref_idx = x.reshape(-1, H, x.shape[-1] // H), idx.reshape(-1, H), ref_idx.reshape(-1, H)
        if not torch.equal(idx, ref_idx):
            flips += int((idx != ref_idx).sum())
            gaps += _index_gaps(x, e, idx, ref_idx).tolist()
    cb_err = max(float((a - b).abs().max()) for a, b in zip(out["cuda"]["codebook"], out["cpu"]["codebook"]))
    log(f"[19] one bf16 step of each phase, card vs CPU: worst loss rel diff {worst:.3g}, codebook max abs diff "
        f"{cb_err:.3g}, {flips} quantizer indices differ at relative distance gaps {[round(g, 6) for g in gaps]}")
    if cb_err > BF16_STEP_TOL["codebook_atol"] or flips > DP_TOL["max_flips"] or any(g > DP_TOL["flip_rel_gap"] for g in gaps):
        raise AssertionError(f"bf16 steps disagree with the CPU: codebook {cb_err}, flips {flips} at gaps {gaps}")
    return {"loss_rel": worst, "codebook_abs": cb_err, "index_flips": flips, "flip_gaps": gaps,
            "card": {k: out["cuda"][k] for k in ("warmup", "gan", "am")},
            "cpu": {k: out["cpu"][k] for k in ("warmup", "gan", "am")}}


def phase_bf16(card, am_path, reference):
    """Phase 19, (a) to (d)."""
    t0 = time.perf_counter()
    result = {"vqgan": phase_bf16_vqgan(card), "am": phase_bf16_am(card),
              "inference": phase_bf16_inference(card, am_path, reference), "card_vs_cpu": phase_bf16_card_vs_cpu()}
    result["phase_s"] = time.perf_counter() - t0
    log(f"[19] bf16 phase {result['phase_s']:.1f}s")
    return result


# phase 20: the model options no shipped recipe sets (ROADMAP A7b) and the int8 decoder under bf16 (A11a)
OPTIONS_DIR = os.path.join(SMOKE_DIR, "options")
# the CSMSC AE recipe's quantizer with every option on: the first step restarts the
# codewords whose counts were zeroed (half of each head's) that got fewer than 90
# frames; a codeword that kept the fixture's count (>= 7.8) cannot fall below 0.9
OPTIONS = {"norm": True, "upsampling": "residual", "restart_dead": 0.9}
# the bf16 int8 decode, card vs CPU on the same state: bf16 activations, whose one-ulp
# roundings (2^-8 relative) the two devices' fp32 sums can tip
BF16_INT8_CPU_REL = 1e-2
LEGACY_AM = "SmokeMelEncoder"  # the legacy TTS task's stand-in acoustic model
LEGACY_LENGTHS = (256, 200, 132)  # mel frames of the legacy task's test list (multiples of 4)


class SmokeMelEncoder(torch.nn.Module):
    """A stand-in acoustic model for the legacy ``TTS`` task, which no
    shipped recipe has: mel -> the port's ``Encoder`` (1x1, a 4-layer
    ResStack, 1x1) -> ``out_dim`` channels, masked."""

    def __init__(self, in_dim=80, out_dim=80, hidden=256):
        super().__init__()
        from msmctts_tpu_torch.models.modules import Encoder

        self.enc = Encoder(in_dim, out_dim, hidden, kernel_size=5, n_layers=4)

    def forward(self, mel, mel_length):
        from msmctts_tpu_torch.ops.masking import sequence_mask

        mask = sequence_mask(mel_length, mel.shape[1], dtype=torch.float32)[..., None]
        return {"mel": self.enc(mel, mask), "mel_length": mel_length}


def register_legacy_am():
    """The stand-in acoustic model in the port's registry, with its weight
    mapping (a JAX ``Encoder`` tree under ``enc``) in the task layer."""
    from msmctts_tpu_torch import registry, tasks
    from msmctts_tpu_torch.weights import encoder_from_jax

    if LEGACY_AM not in registry.NETWORKS:
        registry.register_network(LEGACY_AM)(SmokeMelEncoder)
    tasks._FROM_JAX[LEGACY_AM] = lambda state, name, module: encoder_from_jax(state["params"][name], "enc")


def _fixture_batch(seed):
    rng = np.random.default_rng(seed)
    lengths = np.array(ISTFT_LENGTHS)
    mel = rng.normal(size=(len(lengths), FRAMES, 80)).astype(np.float32) * 0.5
    mel *= (np.arange(FRAMES)[None, :] < lengths[:, None])[..., None]
    return {"mel": mel, "mel_length": lengths}


def _hold_recorded(q_calls, rb_calls, what):
    """Every recorded snap and MRF layer of a path against its plain
    version on the inputs the path gave it -> (snap rows, MRF worst error)."""
    from msmctts_tpu_torch.ops import resblock as rb, vq

    snaps = []
    for x, e in [c[:2] for c in q_calls]:
        idx, quant = vq.vq_nearest(x, e)
        ref_idx, ref_quant = vq.vq_nearest_plain(x, e)
        err, mism = _hold_snap(f"{what} snap N={x.shape[0]}", x, e, idx, quant, ref_idx, ref_quant)
        snaps.append({"N": x.shape[0], "max_abs_err": err, "index_mismatches": mism})
    worst = 0.0
    for x, w1, b1, w2, b2, d, prepared in rb_calls:
        worst = max(worst, _hold_resblock(rb, f"{what} C={x.shape[2]} T={x.shape[1]} d={d}", x, w1, b1, w2, b2, d,
                                          prepared))
    return snaps, worst


def phase_int8_bf16(card, reference):
    """(a) ``--int8`` under ``precision: bfloat16`` on the fixture: the
    int8 decoder built in bf16 as the JAX task builds it."""
    from msmctts_tpu_torch.config import Config
    from msmctts_tpu_torch.models import predictor as predictor_mod, quantizer
    from msmctts_tpu_torch.ops import int8_generator as i8
    from msmctts_tpu_torch.tasks import build_task
    from msmctts_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    fixture = load_checkpoint(FIXTURE)
    tasks = {}
    for name in ("float32", "bfloat16"):
        cfg = Config(fixture["config"])
        cfg["precision"] = name
        tasks[name] = build_task(cfg, device="cuda")
        tasks[name].load_variables(fixture["state"])
        tasks[name].int8_decoder = True
    batch = _fixture_batch(20)
    lengths = batch["mel_length"]
    bf, fp = tasks["bfloat16"], tasks["float32"]
    want = fp.analysis_synthesis(batch)["wav"]  # the first batch of each: quantize, calibrate, decode
    bf.analysis_synthesis(batch)
    dec = bf._int8_state
    if dec.dtype != torch.bfloat16:
        raise AssertionError(f"the bf16 task's int8 decoder computes in {dec.dtype}")
    torch.cuda.synchronize()
    _reset_counts()
    i8.LAUNCHES["int8_conv1d"] = 0
    with _Recorder(quantizer, "vq_nearest_sharded") as q_rec:
        got = bf.analysis_synthesis(batch)["wav"]
    torch.cuda.synchronize()
    counts = {**_counts(), "int8_conv1d": i8.LAUNCHES["int8_conv1d"]}
    _check_wavs(got, lengths, bf.networks["autoencoder"].frameshift_ratio, "bf16 int8 analysis-synthesis")
    if counts != {"vq_nearest": 2, "vq_nearest_stats": 0, "fused_resblock_layer": 0, "int8_conv1d": INT8_SITES}:
        raise AssertionError(f"bf16 int8 analysis-synthesis launches {counts}")
    snaps, _ = _hold_recorded(q_rec.calls, [], "bf16 int8 analysis-synthesis")
    rel_int8 = [_rel_l2(a, b) for a, b in zip(got, want)]
    bf.int8_decoder = False
    bf_float = bf.analysis_synthesis(batch)["wav"]
    bf.int8_decoder = True
    rel_float = [_rel_l2(a, b) for a, b in zip(got, bf_float)]
    log(f"[20] bf16 int8 analysis-synthesis of the fixture B={len(lengths)} frames {lengths.tolist()}: launches {counts}; "
        f"snaps vs plain {json.dumps(snaps)}; relative L2 vs fp32 int8 {[round(r, 4) for r in rel_int8]}, vs the bf16 "
        f"float decoder {[round(r, 4) for r in rel_float]} (bound {INT8_TASK_REL})")
    if max(rel_float) > INT8_TASK_REL:
        raise AssertionError(f"bf16 int8 vs bf16 float decode: relative L2 {max(rel_float)} > {INT8_TASK_REL}")

    # every product of one bf16 decode against its plain version, bit-equal int32
    with torch.inference_mode():
        mel_t, len_t = torch.as_tensor(batch["mel"], device="cuda"), torch.as_tensor(lengths, device="cuda")
        feats = {k: t.networks["autoencoder"].encode_features(mel_t, len_t) for k, t in tasks.items()}
    calls = _int8_sites(lambda: dec.apply(feats["bfloat16"]))
    if len(calls) != INT8_SITES:
        raise AssertionError(f"{len(calls)} int8 products in one bf16 decode, expected {INT8_SITES}")
    for n, (xq, w_q, padding, dilation) in enumerate(calls):
        if not torch.equal(i8.int8_conv1d(xq, w_q, padding, dilation), i8.int8_conv1d_plain(xq, w_q, padding, dilation)):
            raise AssertionError(f"bf16 decode, int8 product {n} {tuple(xq.shape)} x {tuple(w_q.shape)}: sums differ")
    decode_ms = {}
    for _ in range(2):  # in turns
        for name, t in tasks.items():
            decode_ms.setdefault(name, []).append(time_ms(lambda: t._int8_state.apply(feats[name]), runs=3, reps=3, warmup=1))
    log(f"[20] bf16 int8 products: all {len(calls)} sites' int32 sums bit-equal to the plain version; decode of "
        f"B={len(lengths)} x {FRAMES} frames on {card} (CUDA events, in turns): bf16 int8 {decode_ms['bfloat16']} ms, "
        f"fp32 int8 {decode_ms['float32']} ms")

    # the same bf16 int8 state on the CPU (plain products) on the card's features, T = 64
    small = feats["bfloat16"][:1, :64].contiguous()
    card_wav, cpu_wav = dec.apply(small).float().cpu().numpy(), dec.apply(small.cpu()).float().numpy()
    cpu_rel = _rel_l2(card_wav, cpu_wav)
    log(f"[20] bf16 int8 decode T=64, card vs CPU (the same int8 state and features): relative L2 {cpu_rel:.3g}, "
        f"max abs err {float(np.abs(card_wav - cpu_wav).max()):.3g}")
    if cpu_rel > BF16_INT8_CPU_REL:
        raise AssertionError(f"bf16 int8 decode, card vs CPU: relative L2 {cpu_rel}")
    del tasks, feats

    # predict of phase 5's batch of 4 with fp32's durations, bf16 int8 against fp32 int8
    ck = load_checkpoint(reference["am_path"])
    ck["config"]["precision"] = "bfloat16"
    bf16_path = os.path.join(OPTIONS_DIR, "am_seeded_bf16.ckpt")
    save_checkpoint(bf16_path, ck["state"], 0, ck["config"])
    am = {"bfloat16": _load_tts_task(bf16_path, "cuda"), "float32": _load_tts_task(reference["am_path"], "cuda")}
    forced = {**reference["batch"], "dur": np.asarray(reference["out"]["duration"], np.float32)}
    pred = {}
    for name, t in am.items():
        t.int8_decoder = True
        t.predict(forced)  # calibrates on this batch
    torch.cuda.synchronize()
    _reset_counts()
    i8.LAUNCHES["int8_conv1d"] = 0
    with _Recorder(predictor_mod, "vq_nearest_sharded") as p_rec, _Recorder(quantizer, "vq_nearest_sharded") as q_rec:
        pred["bfloat16"] = am["bfloat16"].predict(forced)
    torch.cuda.synchronize()
    p_counts = {**_counts(), "int8_conv1d": i8.LAUNCHES["int8_conv1d"]}
    if p_counts != {"vq_nearest": 4, "vq_nearest_stats": 0, "fused_resblock_layer": 0, "int8_conv1d": INT8_SITES}:
        raise AssertionError(f"bf16 int8 predict launches {p_counts}")
    p_snaps, _ = _hold_recorded(p_rec.calls + q_rec.calls, [], "bf16 int8 predict")
    pred["float32"] = am["float32"].predict(forced)
    p_rel = [_rel_l2(a, b) for a, b in zip(pred["bfloat16"]["wav"], pred["float32"]["wav"])]
    warm = {}
    for _ in range(3):
        for name, t in am.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.predict(forced)
            torch.cuda.synchronize()
            warm.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
    log(f"[20] bf16 int8 predict B=4 (fp32's durations): launches {p_counts} (the predictor's 2 snaps and the "
        f"synthesis's 2; no MRF kernel), snaps vs plain {json.dumps(p_snaps)}; relative L2 vs fp32 "
        f"int8 predict {[round(r, 4) for r in p_rel]}; warm ms bf16 int8 {[round(w, 1) for w in warm['bfloat16']]}, "
        f"fp32 int8 {[round(w, 1) for w in warm['float32']]}")
    return {"launches": counts, "snaps": snaps, "rel_vs_fp32_int8": rel_int8, "rel_vs_bf16_float": rel_float,
            "decode_ms": decode_ms, "cpu_rel": cpu_rel, "predict_launches": p_counts, "predict_snaps": p_snaps,
            "predict_rel_vs_fp32_int8": p_rel, "predict_warm_ms": warm}


def phase_options_training(card):
    """(b) The CSMSC AE recipe at full width with ``OPTIONS`` in its
    quantizer_config: 2 warmup + 2 GAN steps at batch 16, one step card vs
    CPU, the checkpoint through analysis-synthesis in ``residual`` and
    ``mapping`` modes."""
    from msmctts_tpu_torch.config import Config
    from msmctts_tpu_torch.models import hifigan, quantizer
    from msmctts_tpu_torch.tasks import build_task
    from msmctts_tpu_torch.utils.checkpoint import load_checkpoint

    restarted, stats0 = [], {}

    def make():
        cfg = _recipe_config(AE_YAML, os.path.join(OPTIONS_DIR, "ckpt_ae"), warmup_steps=2, quantizer=OPTIONS)
        trainer = _seeded_trainer(cfg, "cuda")
        _from_fixture(trainer)
        q = trainer.ae.quantizer
        if q.transposed_conv is None or len(q.preprocessor[0]) != 4:
            raise AssertionError("the options' autoencoder has no learned upsampler or batch norm")
        with torch.no_grad():
            for vq_stage in q.quantizer:
                vq_stage.cluster_size[:, ::2] = 0.0
        for name, b in trainer.ae.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                stats0[name] = b.clone()
        for vq_stage in q.quantizer:
            vq_stage.register_forward_hook(lambda m, a, o: restarted.append(int((m.cluster_size == 1.0).sum())))
        return trainer

    batch_np, lengths, _ = _training_batch()
    res = _recipe_training(make, batch_np, lengths, card, "[20]", "options")
    first, hk = restarted[:2], VQ_H * VQ_K
    log(f"[20] options {json.dumps(OPTIONS)}: the first step restarted {first} of {hk} codewords per stage")
    if not 0 < sum(first) < 2 * hk:
        raise AssertionError(f"the first step restarted {first} codewords: expected some, not all")
    ckpt = load_checkpoint(res["checkpoint"])
    stats = ckpt["state"]["model_state"]["batch_stats"]["quantizer"]
    # quantizer.preprocessor.<i>.3.running_<mean|var> -> prenorm_<i> {mean, var}
    saved = {k: np.asarray(stats[f"prenorm_{k.split('.')[2]}"]["mean" if k.endswith("mean") else "var"]) for k in stats0}
    moved = {k: float(np.abs(saved[k] - stats0[k].cpu().numpy()).max()) for k in stats0}
    log(f"[20] batch_stats in the checkpoint {sorted(stats)}; moved from the start by {json.dumps(moved)}")
    if sorted(stats) != ["prenorm_0", "prenorm_1"] or min(moved.values()) == 0.0:
        raise AssertionError(f"the quantizer's batch statistics did not move or were not saved: {moved}")
    step = _step_card_vs_cpu(AE_YAML, (120, 88), 300, 20, "[20]", "options", quantizer=OPTIONS)

    # the checkpoint through the inference task, in both learned modes
    batch = _fixture_batch(21)
    modes = {}
    for mode in ("residual", "mapping"):
        cfg = Config(ckpt["config"])
        cfg.task["autoencoder"]["quantizer_config"]["upsampling"] = mode
        task = build_task(cfg, device="cuda")
        task.load_variables(ckpt["state"])
        task.analysis_synthesis(batch)
        torch.cuda.synchronize()
        _reset_counts()
        with _Recorder(quantizer, "vq_nearest_sharded") as q_rec, _Recorder(hifigan, "fused_resblock_layer") as rb_rec:
            out = task.analysis_synthesis(batch)
        torch.cuda.synchronize()
        counts = _counts()
        _check_wavs(out["wav"], batch["mel_length"], task.networks["autoencoder"].frameshift_ratio,
                    f"{mode} analysis-synthesis")
        if counts != {"vq_nearest": 2, "vq_nearest_stats": 0, "fused_resblock_layer": 36}:
            raise AssertionError(f"{mode} analysis-synthesis launches {counts}")
        snaps, rb_worst = _hold_recorded(q_rec.calls, rb_rec.calls, f"{mode} analysis-synthesis")
        modes[mode] = {"launches": counts, "snaps": snaps, "resblock_max_abs_err": rb_worst,
                       "margin": task.padding_reach_frames()}
        log(f"[20] {mode} upsampling, the trained checkpoint's analysis-synthesis B=4: launches {counts}; snaps vs "
            f"plain {json.dumps(snaps)}; 36 MRF layers vs plain max abs err {rb_worst:.3g}; frame margin "
            f"{modes[mode]['margin']}")
        del task
    return {"training": res, "restarted_first_step": first, "batch_stats_moved": moved, "card_vs_cpu": step,
            "modes": modes}


def _legacy_state(ending):
    """The legacy task's config and checkpoint state: the stand-in acoustic
    model (seeded) with the fixture's autoencoder, or with a seeded vocoder
    of the CSMSC recipe's HiFi-GAN (gains in [0.5, 1.5])."""
    from msmctts_tpu_torch.config import Config
    from msmctts_tpu_torch.models.hifigan import HifiGANGenerator
    from msmctts_tpu_torch.utils.checkpoint import load_checkpoint
    from msmctts_tpu_torch.weights import encoder_to_jax, generator_to_jax, init_random, state_dict_numpy

    fixture = load_checkpoint(FIXTURE)
    ae_node = fixture["config"]["task"]["autoencoder"]
    dims = ae_node["quantizer_config"]["embedding_dims"]
    out_dim = 80 if ending == "vocoder" else dims * len(ae_node["encoder_config"]["downsample_scales"])
    am = SmokeMelEncoder(80, out_dim)
    init_random(am, 7)
    task = {"_name": "TTS", "acoustic_model": {"_name": LEGACY_AM, "in_dim": 80, "out_dim": out_dim}}
    state = {"params": {"acoustic_model": encoder_to_jax(state_dict_numpy(am), "enc")}}
    if ending == "autoencoder":
        task["autoencoder"] = ae_node
        state["params"]["autoencoder"] = fixture["state"]["params"]["autoencoder"]
        state["codebook"] = fixture["state"]["codebook"]
    else:
        node = dict(Config(AE_YAML).task["autoencoder"]["decoder_config"], num_mels=80)
        voc = HifiGANGenerator(**node)
        init_random(voc, 8)
        _audible(voc, 8)
        task["vocoder"] = {"_name": "HifiGANGenerator", **node}
        state["params"]["vocoder"] = generator_to_jax(state_dict_numpy(voc))
    mel_dir = os.path.join(OPTIONS_DIR, "legacy", "mel")
    config = {
        "task": task,
        "dataset": {"_name": "MelDataset", "samplerate": 24000, "feature": ["mel"],
                    "feature_path": [os.path.join(mel_dir, "{}.npy")], "dimension": [80], "frameshift": [300],
                    "padding_value": [-4], "segment_length": -1, "id_list": None},
        "save_features": [["wav", ".npy"]],
    }
    return config, state


def phase_legacy_tts(card):
    """(c) The legacy ``TTS`` task on the card, its autoencoder ending over
    the fixture and its vocoder ending (the CSMSC recipe's HiFi-GAN): in
    process with launches and kernels held to plain, then ``infer``'s main
    (in process: phase 16 runs infer as its own process) on a test list of
    mel files against the in-process output."""
    from msmctts_tpu_torch.config import Config
    from msmctts_tpu_torch.models import hifigan, quantizer
    from msmctts_tpu_torch.tasks import build_task
    from msmctts_tpu_torch.utils.checkpoint import save_checkpoint

    register_legacy_am()
    d = os.path.join(OPTIONS_DIR, "legacy")
    os.makedirs(os.path.join(d, "mel"), exist_ok=True)
    rng = np.random.default_rng(22)
    names = [f"legacy{i}" for i in range(len(LEGACY_LENGTHS))]
    mels = [(rng.normal(size=(n, 80)) * 0.5).astype(np.float32) for n in LEGACY_LENGTHS]
    for name, mel in zip(names, mels):
        np.save(os.path.join(d, "mel", f"{name}.npy"), mel)
    test_list = os.path.join(d, "test.yaml")
    with open(test_list, "w") as f:
        json.dump({name: {"mel": os.path.join(d, "mel", f"{name}.npy")} for name in names}, f)  # JSON is YAML
    T = max(LEGACY_LENGTHS)
    batch = {"mel": np.stack([np.pad(m, ((0, T - len(m)), (0, 0)), constant_values=-4.0) for m in mels]),
             "mel_length": np.array(LEGACY_LENGTHS)}
    result, runs = {}, []
    for ending, want_counts in (("autoencoder", {"vq_nearest": 2, "vq_nearest_stats": 0, "fused_resblock_layer": 36}),
                                ("vocoder", {"vq_nearest": 0, "vq_nearest_stats": 0, "fused_resblock_layer": 36})):
        config, state = _legacy_state(ending)
        task = build_task(Config(config), device="cuda")
        task.load_variables(state)
        task.infer_step(batch)
        torch.cuda.synchronize()
        _reset_counts()
        with _Recorder(quantizer, "vq_nearest_sharded") as q_rec, _Recorder(hifigan, "fused_resblock_layer") as rb_rec:
            out = task.infer_step(batch)
        torch.cuda.synchronize()
        counts = _counts()
        ratio = out["wav"][0].shape[0] // LEGACY_LENGTHS[0]
        _check_wavs(out["wav"], batch["mel_length"], ratio, f"legacy TTS ({ending})")
        if counts != want_counts or ratio != 300:
            raise AssertionError(f"legacy TTS ({ending}): launches {counts}, {ratio} samples a frame")
        snaps, rb_worst = _hold_recorded(q_rec.calls, rb_rec.calls, f"legacy TTS ({ending})")
        ckpt = os.path.join(d, f"tts_{ending}.ckpt")
        save_checkpoint(ckpt, state, 1, config)
        out_dir = os.path.join(d, f"out_{ending}")
        runs.append(["-m", ckpt, "-t", test_list, "-o", out_dir])
        result[ending] = {"launches": counts, "snaps": snaps, "resblock_max_abs_err": rb_worst, "wav": out["wav"],
                          "out_dir": out_dir}
        del task
    # both checkpoints through infer's main, in process (phase 16 runs infer as its own process)
    from msmctts_tpu_torch import infer

    t0 = time.perf_counter()
    for args in runs:
        infer.main(args)
    cli_s = time.perf_counter() - t0
    for ending, r in result.items():
        # each line alone in the CLI (batch 1, its own frame bucket) against the in-process batch's row
        out_dir, wavs = r.pop("out_dir"), r.pop("wav")
        r["cli_err"] = max(float(np.abs(np.load(os.path.join(out_dir, f"{name}_wav.npy")) - w).max())
                           for name, w in zip(names, wavs))
        log(f"[20] legacy TTS, {ending} ending: launches per batch of {len(names)} {r['launches']}; snaps vs plain "
            f"{json.dumps(r['snaps'])}; MRF layers vs plain max abs err {r['resblock_max_abs_err']:.3g}; infer "
            f"vs the task's batch: max abs err {r['cli_err']:.3g}")
        if r["cli_err"] > AS_TOL:
            raise AssertionError(f"legacy TTS infer ({ending}) vs in process: {r['cli_err']}")
    log(f"[20] legacy TTS: infer over both checkpoints, in process, on {card}: {cli_s:.1f} s")
    result["cli_s"] = cli_s
    return result


def phase_options(card, reference):
    """Phase 20, (a) to (c)."""
    t0 = time.perf_counter()
    os.makedirs(OPTIONS_DIR, exist_ok=True)
    result = {"int8_bf16": phase_int8_bf16(card, reference), "training": phase_options_training(card),
              "legacy_tts": phase_legacy_tts(card)}
    result["phase_s"] = time.perf_counter() - t0
    log(f"[20] options phase {result['phase_s']:.1f}s")
    return result


# ------------------------------------------------ the train feed and export
# Phase 21: the train feed (the native bulk reader, the wire format, the
# device prefetcher) at the CSMSC recipes' shapes, through train(); then the
# serving weights of phase 5 exported as torch.export programs, run in this
# process, in a fresh one and behind ``serve --artifact``.
FEED_UTTS = 64  # utterances of each synthetic corpus
FEED_AE_FRAMES, FEED_AM_FRAMES = (221, 400), AM_LENGTHS  # frames per utterance: the AE and AM step's buckets 400 / 768
FEED_STEPS = 4  # steps per train() run: 1 warmup, 3 GAN; the loop time of steps 3-4 is kept
FEED_RUNS = ((2, True), (0, True), (2, False), (2, "full"))  # (device_prefetch, wire_compression)
FEED_TURNS = 2
FEED_REPEATED = ((2, True), (2, False))  # the settings a second turn runs: the wire against its noise
# wire true vs false on 16-bit PCM (bit-equal inputs) against the spread of two
# runs of one setting from the same state (the card's own run-to-run noise)
WIRE_NOISE_X = 8
# --feed-ab: the default feed against no prefetch and against the loop's feed
# before it (to_device on the loop's thread), more steps and turns
FEED_AB_RUNS = ((2, True), (0, True), ("to_device", False), (2, False))
FEED_AB_STEPS, FEED_AB_TURNS = 12, 4
LOADER_BATCHES = 3  # batches timed per loader and reading path
EXPORT_B, EXPORT_BUCKETS, EXPORT_FRAMES = 4, (128,), 512  # one text bucket: every request of 24-128 phones


def _write_feed_corpus(d, n_symbols, frames, with_wav, seed):
    """FEED_UTTS utterances of ``frames`` frames: mel [T, 80], (``with_wav``)
    16-bit PCM of T x 300 samples at 24 kHz, and phone / duration books of
    24-96 phones whose durations sum to T. -> the list file."""
    from msmctts_tpu_torch.data.datasets import save_wav

    rng = np.random.default_rng(seed)
    for sub in ("mel", "wav"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    ids, phones, durs = [], [], []
    for i in range(FEED_UTTS):
        uid, f = f"feed{i:03d}", int(rng.integers(frames[0], frames[1] + 1))
        n = int(rng.integers(AM_PHONES[0], AM_PHONES[1] + 1))
        cuts = np.sort(rng.choice(np.arange(1, f), size=n - 1, replace=False))
        dur = np.diff(np.concatenate([[0], cuts, [f]]))
        np.save(os.path.join(d, "mel", f"{uid}.npy"), (rng.normal(size=(f, 80)) * 0.5).astype(np.float32))
        if with_wav:
            save_wav(os.path.join(d, "wav", f"{uid}.wav"), rng.normal(size=f * 300) * 0.1, 24000)
        ids.append(uid)
        phones.append(uid + "|" + " ".join("_".join(str(v) for v in row) for row in _text(rng, [n], n_symbols, n)[0]))
        durs.append(uid + "|" + " ".join(str(int(v)) for v in dur))
    for name, lines in (("train.list", ids), ("phone.txt", phones), ("dur.txt", durs)):
        with open(os.path.join(d, name), "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return os.path.join(d, "train.list")


def _feed_configs(ae_dir, am_dir):
    from msmctts_tpu_torch.config import Config

    ae = _recipe_config(AE_YAML, warmup_steps=1)
    ae.dataset["id_list"] = os.path.join(ae_dir, "train.list")
    ae.dataset["feature_path"] = [os.path.join(ae_dir, "mel", "{}.npy"), os.path.join(ae_dir, "wav", "{}.wav")]
    am = Config(AM_YAML)
    am.dataset["id_list"] = os.path.join(am_dir, "train.list")
    am.dataset["feature_path"] = [os.path.join(am_dir, "phone.txt"), os.path.join(am_dir, "dur.txt"),
                                  os.path.join(am_dir, "mel", "{}.npy")]
    return ae, am


def _loader_rates(cfg, batch_size, tag):
    """Batches per second of the recipe's dataset read in bulk by the native
    reader (``parse_cases``) and file by file, in turns, and through the
    recipe's DataLoader (its worker threads)."""
    from msmctts_tpu_torch.data.loader import DataLoader
    from msmctts_tpu_torch.training.base_trainer import build_dataset_from_config

    cfg = type(cfg)(cfg.to_dict())
    cfg.dataset["pre_load"] = False  # every batch from its files
    ds = build_dataset_from_config(cfg, training=True)
    chunks = [list(range(i * batch_size, (i + 1) * batch_size)) for i in range(LOADER_BATCHES)]
    paths = {"native": lambda c: ds.parse_cases(c), "per_file": lambda c: [ds[i] for i in c]}
    rates = {k: [] for k in paths}
    frame_buckets = set()
    for _ in range(2):
        for name, read in paths.items():
            t0 = time.perf_counter()
            for c in chunks:
                frame_buckets.add(ds.collate_fn(read(c))["mel"].shape[1])
            rates[name].append(LOADER_BATCHES / (time.perf_counter() - t0))
    workers = int(cfg.get("dataloader", {}).get("num_workers", 4))
    t0 = time.perf_counter()  # from the start of its threads: its queue holds batches made ahead
    it = iter(DataLoader(ds, batch_size=batch_size, num_workers=workers, seed=1234))
    for _ in range(4 * LOADER_BATCHES):
        next(it)
    loader = 4 * LOADER_BATCHES / (time.perf_counter() - t0)
    it.close()
    row = {"batch": batch_size, "frame_buckets": sorted(frame_buckets), "native_per_s": rates["native"],
           "per_file_per_s": rates["per_file"], "loader_per_s": loader, "workers": workers}
    log(f"[21] {tag} loader, batch {batch_size} (frame buckets {sorted(frame_buckets)}): batches/s native "
        f"{[round(r, 2) for r in rates['native']]}, per file {[round(r, 2) for r in rates['per_file']]} (in turns), "
        f"the recipe's DataLoader with {workers} workers {loader:.2f} over its first {4 * LOADER_BATCHES}")
    return row


def _feed_trainer(cfg, prefetch, wire, save_dir):
    """The AE recipe's trainer over the feed corpus with the two keys set
    (``prefetch`` "to_device": the loop's feed before the prefetcher); its
    checkpoint writes are left out. Every run starts from the same state:
    ``_feed_run`` rewinds it."""
    from msmctts_tpu_torch.config import component_kwargs
    from msmctts_tpu_torch.registry import get_trainer
    from msmctts_tpu_torch.tasks import build_task

    cfg = type(cfg)(cfg.to_dict())
    cfg["save_checkpoint_dir"] = save_dir
    depth = 0 if prefetch == "to_device" else prefetch
    cfg["dataloader"] = {**cfg["dataloader"], "wire_compression": wire, "device_prefetch": depth}
    task = build_task(cfg, device="cuda", mode="train")
    trainer = get_trainer(cfg.trainer["_name"])(cfg, task, **component_kwargs(cfg.trainer))
    trainer.save = lambda: setattr(trainer, "_last_saved_iteration", trainer.iteration)
    trainer.to_device_feed = prefetch == "to_device"
    return trainer


class _ToDeviceFeed:
    """The loop's feed before the prefetcher: ``to_device(next(batches))``
    on the loop's thread, no wire format."""

    def __init__(self, it, device, mode=True, depth=2):
        self._it, self.device = it, device

    def __iter__(self):
        return self

    def __next__(self):
        from msmctts_tpu_torch.data.loader import to_device

        return to_device(next(self._it), self.device)

    def close(self):
        pass


def _rewind(trainer):
    """The state a fresh trainer starts train() from: train() re-initialises
    the weights from the seed but carries the iteration, the optimizers'
    moments and counts and the dropout / window generator on."""
    trainer.iteration = 0
    trainer.generator.manual_seed(trainer.seed)
    for opt in trainer.optimizers.values():
        opt.opt.state.clear()
        opt.count = 0


def _feed_run(trainer, steps=FEED_STEPS, record_stats=False):
    """One train() of ``steps`` steps from the rewound state: the loop time of
    each step (entry to entry, the last to train()'s return), its metrics,
    the codebooks after each step, the kernels it launched."""
    from msmctts_tpu_torch.models import quantizer
    from msmctts_tpu_torch.training import base_trainer

    _rewind(trainer)
    step, starts, metrics, codebooks = trainer.train_step, [], [], []

    def timed(batch, it, **kw):
        starts.append(time.perf_counter())
        out = step(batch, it, **kw)
        metrics.append({k: float(v) for k, v in out.items()})
        codebooks.append([q.embed.detach().clone() for q in trainer.ae.quantizer.quantizer])
        return out

    trainer.train_step = timed
    rec = _Recorder(quantizer, "vq_nearest_stats_sharded") if record_stats else None
    feed = base_trainer.DevicePrefetcher
    if trainer.to_device_feed:
        base_trainer.DevicePrefetcher = _ToDeviceFeed
    torch.cuda.synchronize()
    _reset_counts()
    try:
        if rec is not None:
            with rec:
                trainer.train(max_steps=steps, log_every=1)
        else:
            trainer.train(max_steps=steps, log_every=1)
        torch.cuda.synchronize()
    finally:
        trainer.train_step = step
        base_trainer.DevicePrefetcher = feed
    starts.append(time.perf_counter())
    loop_ms = [(b - a) * 1e3 for a, b in zip(starts, starts[1:])]
    return {"loop_ms": loop_ms, "warm_ms": statistics.median(loop_ms[2:]), "metrics": metrics, "launches": _counts(),
            "codebooks": codebooks, "stats_calls": rec.calls if rec is not None else []}


def _hold_stats_calls(calls, what, tag="[21]"):
    """Recorded ``vq_nearest_stats_sharded`` calls (x, embed, mask, group)
    against the plain version on their inputs: idx, quant and counts exact,
    sums within ``VQS_TOL``."""
    from msmctts_tpu_torch.ops import vq

    rows = []
    for x, e, mask, _ in calls:
        got, ref = vq.vq_nearest_stats(x, e, mask), vq.vq_nearest_stats_plain(x, e, mask)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got[:3], ref[:3])):
            raise AssertionError(f"{what} N={x.shape[0]}: idx, quant or counts differ from the plain version")
        err = float((got[3] - ref[3]).abs().max())
        if not torch.allclose(got[3], ref[3], **VQS_TOL):
            raise AssertionError(f"{what} N={x.shape[0]}: sums differ by {err}")
        rows.append({"N": x.shape[0], "valid": int(mask.sum()), "sums_max_abs_err": err})
    log(f"{tag} {what}: kernel 2 vs plain on the path's inputs {json.dumps(rows)}")
    return rows


def phase_feed(card, tmp):
    """(a) the feed: the native reader at the recipes' batches, then
    train() in turns over device_prefetch and wire_compression."""
    from msmctts_tpu_torch.data import native

    ae_dir, am_dir = os.path.join(tmp, "ae_corpus"), os.path.join(tmp, "am_corpus")
    n_symbols = list(_am_config().task["predictor"]["n_symbols"])
    t0 = time.perf_counter()
    _write_feed_corpus(ae_dir, n_symbols, FEED_AE_FRAMES, True, 21)
    _write_feed_corpus(am_dir, n_symbols, FEED_AM_FRAMES, False, 22)
    ae_cfg, am_cfg = _feed_configs(ae_dir, am_dir)
    log(f"[21] feed corpora: {FEED_UTTS} utterances of {FEED_AE_FRAMES[0]}-{FEED_AE_FRAMES[1]} frames (mel 80, 24 kHz "
        f"16-bit PCM) and {FEED_UTTS} of {FEED_AM_FRAMES[0]}-{FEED_AM_FRAMES[1]} frames (mel, phones, durations) "
        f"written in {time.perf_counter() - t0:.1f}s")
    before = native.batch_reads()
    rates = {"ae": _loader_rates(ae_cfg, int(ae_cfg["dataloader"]["batch_size"]), "AE recipe"),
             "am": _loader_rates(am_cfg, int(am_cfg["dataloader"]["batch_size"]), "AM recipe")}
    if not native.native_available() or native.batch_reads() <= before:
        raise AssertionError(f"the native reader was not taken (available {native.native_available()}, "
                             f"batch reads {native.batch_reads() - before})")

    runs = _feed_turns(ae_cfg, tmp, FEED_RUNS, FEED_STEPS, FEED_TURNS, record_stats=True, repeated=FEED_REPEATED)
    stats = _hold_stats_calls(runs[FEED_RUNS[0]][0]["stats_calls"][-2:], "train() behind the feed, last step")
    # PCM audio: the int16 wire carries the same waveform, so the runs differ by no
    # more than two runs of one setting from the same state differ on this card
    # (its run-to-run noise): every step's losses and the codebook after the last step
    wire = _wire_vs_noise(runs)
    full_rel = max(_loss_rel(a, b) for a, b in zip(runs[(2, "full")][0]["metrics"], runs[(2, False)][0]["metrics"]))
    warm = {f"prefetch {p}, wire {w}": [round(r["warm_ms"], 1) for r in runs[(p, w)]] for p, w in FEED_RUNS}
    log(f"[21] train() of the AE recipe at batch 16 on {card}, {FEED_STEPS} steps a run from one state ({FEED_TURNS} "
        f"turns), warm loop ms of steps 3-{FEED_STEPS} per run: {json.dumps(warm)}; launches per run "
        f"{runs[FEED_RUNS[0]][0]['launches']}; wire true vs false: losses {wire['diff_loss']:.3g} relative, codebook "
        f"{wire['diff_codebook']:.3g} after step {FEED_STEPS}, against the spread of one setting's two runs "
        f"{wire['noise_loss']:.3g} / {wire['noise_codebook']:.3g} (bound x{WIRE_NOISE_X}); full vs false "
        f"{full_rel:.3g} relative (bf16 mel: not held)")
    return {"loaders": rates, "warm_ms": warm, "loop_ms": {f"{p}/{w}": [r["loop_ms"] for r in runs[(p, w)]]
                                                           for p, w in FEED_RUNS},
            "wire_vs_off": wire, "full_vs_off_rel": full_rel, "stats": stats,
            "launches_per_run": runs[FEED_RUNS[0]][0]["launches"], "native_batch_reads": native.batch_reads() - before}


def _feed_turns(cfg, tmp, settings, steps, turns, record_stats=False, repeated=None):
    """train() of each setting (device_prefetch, wire_compression) for
    ``steps`` steps from one state, the settings in turns (reversed every
    other turn; after the first turn only those in ``repeated``, when
    given); kernel 2 twice a step. -> {setting: [run per turn]}."""
    trainers = {run: _feed_trainer(cfg, *run, os.path.join(tmp, f"ckpt_{run[0]}_{run[1]}")) for run in settings}
    runs = {run: [] for run in settings}
    for turn in range(turns):
        order = settings if turn % 2 == 0 else settings[::-1]
        for run in (order if turn == 0 or repeated is None else [r for r in order if r in repeated]):
            res = _feed_run(trainers[run], steps, record_stats=record_stats and turn == 0 and run == settings[0])
            want = {"vq_nearest": 0, "vq_nearest_stats": 2 * steps, "fused_resblock_layer": 0}
            if res["launches"] != want:
                raise AssertionError(f"train() with device_prefetch {run[0]}, wire {run[1]}: launches {res['launches']}")
            runs[run].append(res)
    del trainers
    torch.cuda.empty_cache()
    return runs


def _loss_rel(x, y):
    return max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-6) for k in y)


def _codebook_diff(a, b):
    """Max abs difference of two runs' codebooks after their last step."""
    return max(float((p - q).abs().max()) for p, q in zip(a["codebooks"][-1], b["codebooks"][-1]))


def _wire_vs_noise(runs):
    """Wire true against false, turn by turn, held to ``WIRE_NOISE_X`` times
    the spread between the two turns of each of them (the same setting from
    the same state)."""
    on, off = runs[(2, True)], runs[(2, False)]
    loss = lambda a, b: max(_loss_rel(x, y) for x, y in zip(a["metrics"], b["metrics"]))
    diff_loss = max(loss(a, b) for a, b in zip(on, off))
    diff_cb = max(_codebook_diff(a, b) for a, b in zip(on, off))
    noise_loss = max(loss(r[0], r[1]) for r in (on, off))
    noise_cb = max(_codebook_diff(r[0], r[1]) for r in (on, off))
    out = {"diff_loss": diff_loss, "diff_codebook": diff_cb, "noise_loss": noise_loss, "noise_codebook": noise_cb}
    if diff_loss > WIRE_NOISE_X * noise_loss or diff_cb > WIRE_NOISE_X * noise_cb:
        raise AssertionError(f"train() on the int16 wire vs off beyond {WIRE_NOISE_X}x the card's run-to-run spread: {out}")
    return out


def feed_ab(card):
    """``--feed-ab``: warm AE steps through train() with the default feed
    (prefetch 2, int16 wire), no prefetch, the loop's feed before the
    prefetcher (to_device on the loop's thread) and prefetch without the
    wire, FEED_AB_STEPS steps a run in FEED_AB_TURNS turns."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="msmctts_feed_ab_")
    try:
        d = os.path.join(tmp, "ae_corpus")
        _write_feed_corpus(d, list(_am_config().task["predictor"]["n_symbols"]), FEED_AE_FRAMES, True, 21)
        cfg = _feed_configs(d, d)[0]
        runs = _feed_turns(cfg, tmp, FEED_AB_RUNS, FEED_AB_STEPS, FEED_AB_TURNS)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rows = {}
    for p, w in FEED_AB_RUNS:
        gan = [ms for r in runs[(p, w)] for ms in r["loop_ms"][2:]]  # GAN steps 3-12 of every run
        rows[f"{p}/{w}"] = {"median_ms": statistics.median(gan), "per_turn_median_ms": [r["warm_ms"] for r in runs[(p, w)]],
                            "steps": len(gan)}
    log(f"[ab] train() of the AE recipe at batch 16 on {card}, {FEED_AB_STEPS} steps a run from one state, "
        f"{FEED_AB_TURNS} turns: warm GAN loop ms {json.dumps(rows)}")
    return rows


def _export_holds(art, batch, what, int8=False):
    """Run the artifact once on ``batch`` with every kernel launch recorded:
    -> (outputs, launches, snap rows, MRF worst error, int8 products held)."""
    from msmctts_tpu_torch.ops import int8_generator as i8, resblock as rb, vq

    torch.cuda.synchronize()
    _reset_counts()
    i8.LAUNCHES["int8_conv1d"] = 0
    with _Recorder(vq, "vq_nearest") as q_rec, _Recorder(rb, "fused_resblock_layer") as rb_rec, \
            _Recorder(i8, "_int8_conv1d_im2col") as i8_rec:
        wav, wav_length, mel_length = art.run(batch["text"], batch["text_length"])
        torch.cuda.synchronize()
    counts = {**_counts(), "int8_conv1d": i8.LAUNCHES["int8_conv1d"]}
    want = {"vq_nearest": 4, "vq_nearest_stats": 0, "fused_resblock_layer": 0 if int8 else 36,
            "int8_conv1d": INT8_SITES if int8 else 0}
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")
    snaps, rb_worst = _hold_recorded(q_rec.calls, rb_rec.calls, what)
    for n, (xq, w_q, padding, dilation) in enumerate(i8_rec.calls):
        y, ref = i8.int8_conv1d(xq, w_q, padding, dilation), i8.int8_conv1d_plain(xq, w_q, padding, dilation)
        if not torch.equal(y, ref):
            raise AssertionError(f"{what}: int8 product {n} differs from the plain version")
    return (wav, wav_length, mel_length), counts, snaps, rb_worst, len(i8_rec.calls)


def _against_predict(wavs, mel_length, want, what):
    """Durations (frame totals) equal and each wav within AS_TOL of ``want``'s."""
    if not np.array_equal(np.asarray(mel_length), np.asarray(want["mel_length"])):
        raise AssertionError(f"{what}: frames {np.asarray(mel_length).tolist()}, predict {want['mel_length'].tolist()}")
    err = 0.0
    for a, b in zip(wavs, want["wav"]):
        if a.shape != b.shape:
            raise AssertionError(f"{what}: {a.shape} samples, predict {b.shape}")
        err = max(err, float(np.abs(a - b).max()))
    if err > AS_TOL:
        raise AssertionError(f"{what}: wav max abs err {err} against predict")
    return err


def phase_export(card, am_path, reference, tmp):
    """(b) export of phase 5's serving weights and the artifacts' runs."""
    from msmctts_tpu_torch.export import ExportedTTS, save_artifacts
    from msmctts_tpu_torch.ops import cuda_build
    from msmctts_tpu_torch.serving import BatchingEngine
    from msmctts_tpu_torch.serve import pcm16

    task = _load_tts_task(am_path, "cuda")
    batch = reference["batch"]  # phase 5's batch: 24 / 57 / 96 / 128 phones in text bucket 128
    art_dir, i8_dir = os.path.join(tmp, "artifact"), os.path.join(tmp, "artifact_int8")
    m = save_artifacts(task, art_dir, EXPORT_B, EXPORT_BUCKETS, EXPORT_FRAMES, task.samplerate, platforms=("cuda",))
    sizes = {n: os.path.getsize(os.path.join(art_dir, n)) / 1e6 for n in m["export_s"]}
    log(f"[21] exported phase 5's serving weights at batch {EXPORT_B}, text buckets {list(EXPORT_BUCKETS)}, "
        f"{EXPORT_FRAMES} frames for cuda: seconds per program {json.dumps({n: round(s, 1) for n, s in m['export_s'].items()})}, "
        f"MB {json.dumps({n: round(s, 1) for n, s in sizes.items()})}")
    task.static_max_frames = EXPORT_FRAMES
    want = task.predict(batch)
    task.static_max_frames = None

    art = ExportedTTS(art_dir, "cuda")
    t0 = time.perf_counter()
    art.run(batch["text"], batch["text_length"])  # loads the bucket's program
    torch.cuda.synchronize()
    load_first_s = time.perf_counter() - t0
    (wav, wav_length, mel_length), counts, snaps, rb_worst, _ = _export_holds(art, batch, "the fp32 artifact")
    wav, wav_length = wav.cpu().numpy(), wav_length.cpu().numpy()
    err = _against_predict([w[:n] for w, n in zip(wav, wav_length)], mel_length.cpu().numpy(), want,
                           "the fp32 artifact in process")
    warm = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        art.run(batch["text"], batch["text_length"])
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
    log(f"[21] the fp32 artifact in process, phase 5's batch (bucket {batch['text'].shape[1]}): launches {counts}; "
        f"snaps vs plain {json.dumps(snaps)}; 36 MRF layers vs plain max abs err {rb_worst:.3g}; frames equal to "
        f"predict at {EXPORT_FRAMES} static frames, wav max abs err {err:.3g}; load + first run {load_first_s:.1f}s, warm "
        f"median {statistics.median(warm):.1f} ms (runs {[round(w, 1) for w in warm]})")

    # one fresh process: the artifact alone (phase 5's batch, no model module
    # imported), then serve --artifact's main over the same programs, against
    # an in-process engine on them; it starts here, its start overlapping the
    # int8 artifact's export and holds
    np.savez(os.path.join(tmp, "batch.npz"), text=batch["text"], text_length=batch["text_length"])
    code = ("import sys, json, numpy as np\n"
            "from msmctts_tpu_torch.export import ExportedTTS\n"
            "tmp = sys.argv[1]\n"
            "b = np.load(tmp + '/batch.npz')\n"
            "out = ExportedTTS(tmp + '/artifact').run(b['text'], b['text_length'])\n"
            "wav, wav_length, mel_length = (t.cpu().numpy() for t in out)\n"
            "np.savez(tmp + '/fresh.npz', wav=wav, wav_length=wav_length, mel_length=mel_length)\n"
            "models = sorted(m for m in sys.modules if m.startswith('msmctts_tpu_torch.models'))\n"
            "print('fresh ' + json.dumps({'models': models}), flush=True)\n"
            "from msmctts_tpu_torch import serve\n"
            "serve.main(['--artifact', tmp + '/artifact', '--port', '0', '--window-ms', '0'])\n")
    proc, lines, t0 = _start_daemon("-c", code, tmp)

    # the int8 artifact: calibrated on phase 5's batch, then frozen
    task.int8_decoder = True
    task.static_max_frames = EXPORT_FRAMES
    want8 = task.predict(batch)  # calibrates the scales
    m8 = save_artifacts(task, i8_dir, EXPORT_B, EXPORT_BUCKETS[-1:], EXPORT_FRAMES, task.samplerate, platforms=("cuda",),
                        int8=True)
    task.int8_decoder = False
    task.static_max_frames = None
    art8 = ExportedTTS(i8_dir, "cuda")
    art8.run(batch["text"], batch["text_length"])
    (wav8, len8, mel8), counts8, snaps8, _, n_products = _export_holds(art8, batch, "the int8 artifact", int8=True)
    wav8, len8 = wav8.cpu().numpy(), len8.cpu().numpy()
    err8 = _against_predict([w[:n] for w, n in zip(wav8, len8)], mel8.cpu().numpy(), want8, "the int8 artifact")
    log(f"[21] the int8 artifact (exported in {json.dumps({n: round(s, 1) for n, s in m8['export_s'].items()})}s): "
        f"launches {counts8}; {n_products} int8 products bit-equal to plain; snaps vs plain {json.dumps(snaps8)}; "
        f"frames equal to the int8 predict, wav max abs err {err8:.3g}")
    del art8

    rng = np.random.default_rng(21)
    n_symbols = list(task.networks["predictor"].n_symbols)
    texts = [_phone_string(_text(rng, [int(n)], n_symbols, int(n))[0]) for n in (24, 57, 96, 128)]
    eng = BatchingEngine(art, sample_rate=art.sample_rate, batch_size=art.batch_size, window_ms=0.0,
                         text_buckets=art.buckets)
    eng.start(warmup={})
    try:
        alone = {t: eng.synthesize(t, timeout=SERVE_TIMEOUT_S) for t in texts}
    finally:
        eng.stop()
    builds_before = cuda_build.build_count()
    try:
        fresh_line = _wait_for_line(lines, "fresh ", proc, SERVE_TIMEOUT_S, tag="[21]")
        models = json.loads(fresh_line[len("fresh "):])["models"]
        fresh_s = _arrival(lines, fresh_line) - t0
        warm_line = _wait_for_line(lines, "warmup:", proc, SERVE_TIMEOUT_S, tag="[21]")
        serving_line = _wait_for_line(lines, "serving on", proc, 60, tag="[21]")
        port = int(serving_line.rsplit(":", 1)[1])
        ready_s = _arrival(lines, serving_line) - t0
        results = [_http(port, "POST", "/synthesize", {"text": t}) for t in texts]
        _, data, _, _ = _http(port, "GET", "/stats")
        stats = json.loads(data)
    finally:
        _stop(proc)
    fresh = np.load(os.path.join(tmp, "fresh.npz"))
    fresh_err = _against_predict([w[:n] for w, n in zip(fresh["wav"], fresh["wav_length"])], fresh["mel_length"], want,
                                 "the fp32 artifact in a fresh process")
    if models:
        raise AssertionError(f"the fresh process imported model modules: {models}")
    log(f"[21] the fp32 artifact in a fresh process ({fresh_s:.1f}s to its result, the int8 export meanwhile): no model "
        f"module imported, frames "
        f"equal to predict, wav max abs err {fresh_err:.3g}")
    served_lsb = 0
    for t, r in zip(texts, results):
        if r[0] != 200:
            raise AssertionError(f"serve --artifact: {len(t.split())} phones answered {r[0]}: {r[1][:200]!r}")
        got = _pcm(r[1], False).astype(np.int32)
        ref = np.frombuffer(pcm16(alone[t]), "<i2").astype(np.int32)
        if got.shape != ref.shape:
            raise AssertionError(f"serve --artifact: {got.shape} samples, in process {ref.shape}")
        served_lsb = max(served_lsb, int(np.abs(got - ref).max()))
    if (stats["cold_shapes"], stats["kernel_builds"], stats["errors"]) != (0, 0, 0) or served_lsb > 1 \
            or not warm_line.rstrip().endswith("kernel builds 0)") or cuda_build.build_count() != builds_before:
        raise AssertionError(f"serve --artifact: /stats {stats}, served vs in process {served_lsb} LSB, {warm_line!r}")
    log(f"[21] serve --artifact (its main, in that process) ready {ready_s:.1f}s after the start ({warm_line.strip()}); "
        f"{len(texts)} requests of "
        f"{[len(t.split()) for t in texts]} phones, each equal to the in-process engine on the artifact within "
        f"{served_lsb} LSB; /stats cold_shapes {stats['cold_shapes']}, kernel_builds {stats['kernel_builds']}, "
        f"errors {stats['errors']}")

    # the eager path's direct launches against every wrapper of predict going
    # through its msmctts:: operator (the exported programs' route), in turns:
    # predict at phase 5's batch, then the host cost per call of the snap alone
    ab = _operator_ab(task, batch, card)
    del art, task
    return {"export_s": m["export_s"], "export_mb": sizes, "launches": counts, "snaps": snaps, "resblock_max_abs_err": rb_worst,
            "wav_err": err, "fresh_wav_err": fresh_err, "fresh_s": fresh_s, "warm_ms": statistics.median(warm),
            "load_first_s": load_first_s, "int8": {"export_s": m8["export_s"], "launches": counts8, "snaps": snaps8,
                                                   "products": n_products, "wav_err": err8},
            "daemon": {"ready_s": ready_s, "served_lsb": served_lsb, "stats": stats},
            "operator_ab": ab}


def _operator_ab(task, batch, card, turns=3, runs=3, calls=400):
    """``predict`` with the wrappers as shipped (a direct launch) against
    every wrapper it calls (4 snaps, 36 MRF layers) routed through its
    ``msmctts::`` operator, in turns; then ``vq_nearest`` alone at N = 512
    (a 10 us kernel, so the wall per call is the host's) both ways."""
    from msmctts_tpu_torch.models import hifigan, predictor as predictor_mod, quantizer
    from msmctts_tpu_torch.ops import vq

    ops = torch.ops.msmctts
    routes = {"direct": {}, "operator": {
        (hifigan, "fused_resblock_layer"): lambda x, w1, b1, w2, b2, d, prepared=None: ops.fused_resblock_layer(
            x, w1, b1, w2, b2, d, prepared),
        (predictor_mod, "vq_nearest_sharded"): lambda x, e: ops.vq_nearest(x, e),
        (quantizer, "vq_nearest_sharded"): lambda x, e: ops.vq_nearest(x, e)}}
    shipped = {key: getattr(*key) for key in routes["operator"]}
    times = {name: [] for name in routes}
    try:
        for turn in range(turns):
            name = "direct" if turn % 2 == 0 else "operator"
            for (mod, attr), fn in shipped.items():
                setattr(mod, attr, routes[name].get((mod, attr), fn))
            _reset_counts()
            for _ in range(runs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                task.predict(batch)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
            counts = _counts()
            if counts != {"vq_nearest": 4 * runs, "vq_nearest_stats": 0, "fused_resblock_layer": 36 * runs}:
                raise AssertionError(f"predict through the {name} route: launches {counts}")
    finally:
        for (mod, attr), fn in shipped.items():
            setattr(mod, attr, fn)
    x = torch.randn(512, VQ_H, VQ_D, device="cuda")
    e = torch.randn(VQ_H, VQ_D, VQ_K, device="cuda")
    per_call = {"direct": [], "operator": []}
    for turn in range(turns):
        name = "direct" if turn % 2 == 0 else "operator"
        fn = vq.vq_nearest if name == "direct" else ops.vq_nearest
        fn(x, e)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(x, e)
        torch.cuda.synchronize()
        per_call[name].append((time.perf_counter() - t0) / calls * 1e6)
    med = {k: statistics.median(v) for k, v in times.items()}
    us = {k: statistics.median(v) for k, v in per_call.items()}
    log(f"[21] predict warm on {card}, phase 5's batch, in turns: wrappers launching directly {med['direct']:.1f} ms, "
        f"through their msmctts:: operators {med['operator']:.1f} ms (runs "
        f"{json.dumps({k: [round(t, 1) for t in v] for k, v in times.items()})}); vq_nearest at N = 512, wall per call "
        f"over {calls} back-to-back calls: direct {us['direct']:.1f} us, operator {us['operator']:.1f} us (turns "
        f"{json.dumps({k: [round(t, 1) for t in v] for k, v in per_call.items()})})")
    return {"predict_ms": times, "predict_median_ms": med, "vq_call_us": per_call, "vq_call_median_us": us}


def phase_feed_and_export(card, am_path, reference):
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="msmctts_phase21_")
    try:
        t0 = time.perf_counter()
        feed = phase_feed(card, tmp)
        t1 = time.perf_counter()
        export = phase_export(card, am_path, reference, tmp)
        log(f"[21] feed {t1 - t0:.1f}s, export {time.perf_counter() - t1:.1f}s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"feed": feed, "export": export}


# ------------------------------------------------ orbax snapshots
# Phase 22: checkpoint_backend: orbax on the card. The CSMSC AE recipe
# trains through train() and writes a snapshot (OCDBT + zarr, the port's own
# writer on a worker thread); a fresh trainer resumes from it bit for bit
# and steps as one resumed from a pickle of the same state does; phase 5's
# serving weights as snapshots through infer.
ORBAX_STEPS = 2  # through train(): 1 warmup + 1 GAN step, then the final save


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path) for f in files)


def _tree_leaves(tree, path=""):
    """(path, leaf) of nested dicts / lists / tuples, keys as strings: a
    pickle's int key or tuple reads as a snapshot's string key or list."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _same_leaves(got, want, what):
    """Two state trees leaf for leaf, bit for bit -> the number of leaves."""
    g, w = dict(_tree_leaves(got)), dict(_tree_leaves(want))
    if sorted(g) != sorted(w):
        raise AssertionError(f"{what}: the trees differ in {sorted(set(g) ^ set(w))[:8]}")
    for k, v in w.items():
        if isinstance(v, np.ndarray):
            a = np.asarray(g[k])
            if a.dtype != v.dtype or a.shape != v.shape or a.tobytes() != v.tobytes():
                raise AssertionError(f"{what}: {k} differs ({a.dtype} {a.shape} vs {v.dtype} {v.shape})")
        elif g[k] != v:
            raise AssertionError(f"{what}: {k} is {g[k]!r}, saved {v!r}")
    return len(w)


class _Deterministic:
    """Deterministic algorithms for a block: cuDNN's default choices are
    not bitwise repeatable (two ``infer`` runs of one pickle differ in the
    last bits), and bit-equality between two runs is what this phase holds."""

    def __enter__(self):
        self.saved = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
                      torch.backends.cudnn.benchmark)
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        return self

    def __exit__(self, *exc):
        torch.use_deterministic_algorithms(self.saved[0])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = self.saved[1], self.saved[2]


def _orbax_trainer(cfg):
    from msmctts_tpu_torch.config import component_kwargs
    from msmctts_tpu_torch.registry import get_trainer
    from msmctts_tpu_torch.tasks import build_task

    task = build_task(cfg, device="cuda", mode="train")
    return get_trainer(cfg.trainer["_name"])(cfg, task, **component_kwargs(cfg.trainer))


def phase_orbax_training(card, tmp):
    """(a) train() with checkpoint_backend: orbax and its snapshot; (b) a
    fresh trainer resumed from it against one resumed from a pickle."""
    from msmctts_tpu_torch.data.loader import to_device
    from msmctts_tpu_torch.models import quantizer
    from msmctts_tpu_torch.training.base_trainer import metrics_to_host
    from msmctts_tpu_torch.utils import checkpoint, zstd
    from msmctts_tpu_torch.utils.checkpoint import read_checkpoint

    ae_dir = os.path.join(tmp, "ae")
    _write_feed_corpus(ae_dir, list(_am_config().task["predictor"]["n_symbols"]), FEED_AE_FRAMES, True, 22)
    cfg = _recipe_config(AE_YAML, os.path.join(tmp, "orbax"), warmup_steps=1)
    cfg.dataset["id_list"] = os.path.join(ae_dir, "train.list")
    cfg.dataset["feature_path"] = [os.path.join(ae_dir, "mel", "{}.npy"), os.path.join(ae_dir, "wav", "{}.wav")]
    cfg["checkpoint_backend"] = "orbax"
    cfg["pretrain_checkpoint_path"] = FIXTURE  # phase 6's state: the fixture's autoencoder, a seeded discriminator
    cfg["iters_per_checkpoint"] = 10 * ORBAX_STEPS  # the final save alone

    # (a) the writer: the train thread's stall in save(), the writer thread's time
    trainer = _orbax_trainer(cfg)
    commit, stall = checkpoint._commit_state, []

    def timed_commit(path, tree):
        t0 = time.perf_counter()
        commit(path, tree)
        stall.append(("writer", time.perf_counter() - t0))

    save = trainer.save

    def timed_save():
        t0 = time.perf_counter()
        out = save()
        stall.append(("save", time.perf_counter() - t0))
        return out

    trainer.save, checkpoint._commit_state = timed_save, timed_commit
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    try:
        trainer.train(max_steps=ORBAX_STEPS, log_every=1)  # its finally waits for the writer
    finally:
        checkpoint._commit_state = commit
    train_s = time.perf_counter() - t0
    counts = _counts()
    if counts != {"vq_nearest": 0, "vq_nearest_stats": 2 * ORBAX_STEPS, "fused_resblock_layer": 0}:
        raise AssertionError(f"train() with the orbax backend: launches {counts}")
    snap = os.path.join(cfg["save_checkpoint_dir"], f"model_{ORBAX_STEPS}")
    if sorted(os.listdir(snap)) != ["meta.pkl", "state"]:
        raise AssertionError(f"{snap}: {sorted(os.listdir(snap))}")
    t0 = time.perf_counter()
    saved = trainer.checkpoint_state()  # nothing moved since the final save
    state_s = time.perf_counter() - t0
    # the same state through the pickle backend's save(), timed as the orbax one
    pkl_dir = os.path.join(tmp, "pickle")
    trainer.checkpoint_backend, trainer.save_dir = "pickle", pkl_dir
    trainer.save()
    pkl = os.path.join(pkl_dir, f"model_{ORBAX_STEPS}")
    (save_s, pickle_s), writer_s = [t for k, t in stall if k == "save"], dict(stall)["writer"]
    snap_mb, pkl_mb = _dir_bytes(snap) / 1e6, os.path.getsize(pkl) / 1e6
    log(f"[22] train() {ORBAX_STEPS} steps with checkpoint_backend: orbax ({train_s:.1f}s, launches {counts}); snapshot "
        f"{snap_mb:.1f} MB vs pickle of the same state {pkl_mb:.1f} MB ({snap_mb / pkl_mb:.4f}x); train thread's stall in "
        f"save() {save_s * 1e3:.1f} ms (the pickle backend's save() of the same state {pickle_s * 1e3:.1f} ms; the state "
        f"tree on the host alone {state_s * 1e3:.1f} ms); writer thread {writer_s:.2f}s, {snap_mb / writer_s:.0f} MB/s; "
        f"zstd decoder built {zstd.builds()} time(s) here")

    # (b) resume: every leaf of the snapshot, then a fresh trainer's whole state
    t0 = time.perf_counter()
    stored = read_checkpoint(snap)
    read_s = time.perf_counter() - t0
    n_leaves = _same_leaves(stored["state"], saved, "the snapshot as read")
    resumed = {}
    for name, d in (("orbax", cfg["save_checkpoint_dir"]), ("pickle", pkl_dir)):
        c = type(cfg)(cfg.to_dict())
        c["save_checkpoint_dir"] = d
        t0 = time.perf_counter()
        resumed[name] = _orbax_trainer(c)
        resumed[name].attempt_resume()
        torch.cuda.synchronize()
        resumed[name + "_s"] = time.perf_counter() - t0
        if resumed[name].iteration != ORBAX_STEPS:
            raise AssertionError(f"the {name} resume is at iteration {resumed[name].iteration}")
        _same_leaves(resumed[name].checkpoint_state(), saved, f"the trainer resumed from the {name} checkpoint")
    log(f"[22] resume: read {snap_mb:.1f} MB in {read_s:.2f}s ({snap_mb / read_s:.0f} MB/s, {n_leaves} leaves bit-equal "
        f"to what was saved, torch_opt_state and torch_rng included); attempt_resume() from the snapshot "
        f"{resumed['orbax_s']:.2f}s, from the pickle {resumed['pickle_s']:.2f}s; both trainers' states bit-equal to it")

    # one more GAN step from each resume
    batch = to_device(_training_batch()[0], "cuda")
    metrics, launches, calls = {}, {}, []
    with _Deterministic():
        for name in ("orbax", "pickle"):
            torch.cuda.synchronize()
            _reset_counts()
            with _Recorder(quantizer, "vq_nearest_stats_sharded") as rec:
                metrics[name] = metrics_to_host(resumed[name].train_step(batch, ORBAX_STEPS + 1))
            torch.cuda.synchronize()
            launches[name] = _counts()
            if name == "orbax":
                calls = rec.calls
    for name, c in launches.items():
        if c != {"vq_nearest": 0, "vq_nearest_stats": 2, "fused_resblock_layer": 0}:
            raise AssertionError(f"the GAN step after the {name} resume: launches {c}")
    if "fm_loss" not in metrics["orbax"] or metrics["orbax"] != metrics["pickle"]:
        diff = {k: (metrics["orbax"][k], metrics["pickle"].get(k)) for k in metrics["orbax"]
                if metrics["orbax"][k] != metrics["pickle"].get(k)}
        raise AssertionError(f"the GAN step after the orbax resume differs from the one after the pickle resume: {diff}")
    stats = _hold_stats_calls(calls, "the GAN step after the orbax resume", tag="[22]")
    shown = {k: round(metrics["orbax"][k], 5) for k in ("g_loss", "d_loss", "fm_loss", "stft_loss")}
    log(f"[22] one GAN step after each resume: metrics bit-equal {shown}, launches {launches['orbax']} each")
    del trainer, resumed
    return {"train_s": train_s, "launches_train": counts, "snapshot_mb": snap_mb, "pickle_mb": pkl_mb,
            "save_stall_ms": save_s * 1e3, "pickle_save_ms": pickle_s * 1e3, "state_tree_ms": state_s * 1e3,
            "writer_s": writer_s,
            "write_mb_per_s": snap_mb / writer_s, "read_s": read_s, "read_mb_per_s": snap_mb / read_s,
            "leaves": n_leaves, "launches_resumed_step": launches["orbax"], "stats": stats,
            "metrics_after_resume": metrics["orbax"]}


def phase_orbax_serving(card, am_path, tmp):
    """(c) phase 5's serving weights as snapshots (the fixture's autoencoder
    and the seeded acoustic model) through infer, against infer of the
    pickles."""
    import yaml

    from msmctts_tpu_torch import infer
    from msmctts_tpu_torch.models import hifigan, predictor as predictor_mod, quantizer
    from msmctts_tpu_torch.utils.checkpoint import read_checkpoint, save_checkpoint_orbax, wait_for_pending_saves

    fixture, am = read_checkpoint(FIXTURE), read_checkpoint(am_path)
    ae_snap = save_checkpoint_orbax(os.path.join(tmp, "serve", "fixture"), fixture["state"], fixture["iteration"],
                                    fixture["config"])
    am["config"]["task"]["autoencoder"]["_checkpoint"] = ae_snap
    am_snap = save_checkpoint_orbax(os.path.join(tmp, "serve", "am"), am["state"], am["iteration"], am["config"])
    wait_for_pending_saves()
    rng = np.random.default_rng(22)
    n_symbols = list(am["config"]["task"]["predictor"]["n_symbols"])
    texts = {f"u{i}": " ".join("_".join(str(v) for v in row) for row in _text(rng, [n], n_symbols, n)[0])
             for i, n in enumerate((24, 57, 96, 128))}
    test_list, cfg_path = os.path.join(tmp, "serve", "test.yaml"), os.path.join(tmp, "serve", "npy.yaml")
    with open(test_list, "w") as fh:
        yaml.safe_dump({u: {"text": t} for u, t in texts.items()}, fh)
    outs, ms = {}, {}
    with _Deterministic():  # both runs bit-equal only so
        for name, model in (("snapshot", am_snap), ("pickle", am_path)):
            cfg = read_checkpoint(model)["config"]
            cfg["save_features"] = [["wav", ".npy"]]  # the float waveform, not 16-bit PCM
            with open(cfg_path, "w") as fh:
                yaml.safe_dump(cfg, fh)
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            if name == "snapshot":
                with _Recorder(predictor_mod, "vq_nearest_sharded") as p_rec, \
                        _Recorder(quantizer, "vq_nearest_sharded") as q_rec, _Recorder(hifigan, "fused_resblock_layer") as rb_rec:
                    outs[name] = infer.main(["-m", model, "-c", cfg_path, "-t", test_list, "-o",
                                             os.path.join(tmp, "serve", name), "-b", "4"])
                counts = _counts()
            else:
                outs[name] = infer.main(["-m", model, "-c", cfg_path, "-t", test_list, "-o",
                                         os.path.join(tmp, "serve", name), "-b", "4"])
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t0) * 1e3
    if counts != {"vq_nearest": 4, "vq_nearest_stats": 0, "fused_resblock_layer": 36}:
        raise AssertionError(f"infer -m <snapshot>, one batch of 4: launches {counts}")
    frames = {}
    for u in texts:
        a, b = (np.load(os.path.join(outs[n], f"{u}_wav.npy")) for n in ("snapshot", "pickle"))
        if a.size == 0 or a.shape != b.shape or a.tobytes() != b.tobytes():
            raise AssertionError(f"infer of the snapshot, {u}: its wav differs from infer of the pickle")
        frames[u] = a.shape[0] // 300
    snaps, rb_worst = _hold_recorded(p_rec.calls + q_rec.calls, rb_rec.calls, "[22] infer -m <snapshot>")
    log(f"[22] infer -m <snapshot> (the AM over the fixture's snapshot) {ms['snapshot']:.0f} ms vs the pickles "
        f"{ms['pickle']:.0f} ms: 4 utterances of {list(frames.values())} frames, wav bit-equal; launches {counts}, "
        f"snaps vs plain {json.dumps(snaps)}, MRF layers vs plain max abs err {rb_worst:.3g}")
    return {"launches": counts, "snaps": snaps, "resblock_max_abs_err": rb_worst, "frames": frames, "infer_ms": ms}


def phase_orbax(card, am_path):
    """Phase 22, (a) to (c)."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="msmctts_phase22_")
    try:
        training = phase_orbax_training(card, tmp)
        serving = phase_orbax_serving(card, am_path, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"training": training, "serving": serving}


# ------------------------------------------ inference over a group, tensor parallelism
# Phase 23: (a) the serving daemon over two ranks on the one card (serve
# --mesh-devices 2 --devices 0,0 --backend gloo) under 8 clients, every
# answer held against the one-rank in-process engine, and infer
# --mesh-devices 2 with a padded last batch against one-rank infer; (b)
# tensor parallelism: the CSMSC AE recipe at full width over data 2 x model 2
# (heads split) on 4 ranks, phase 10's steps from phase 6's state held against
# phase 6's run, its checkpoint into one rank, then one AM step at batch 64
# against phase 12's.
GROUP_CLIENTS, GROUP_REQUESTS, GROUP_STREAM_EVERY = 8, 16, 4
GROUP_INFER_TEXTS, GROUP_INFER_B = 5, 4
TP_MESH = {"data": 2, "model": 2}
TP_WORLD = TP_MESH["data"] * TP_MESH["model"]


def phase_group_serving(card, am_path, seed=23):
    """(a) the daemon over two ranks and infer --mesh-devices 2."""
    import shutil
    import tempfile
    import threading

    import yaml
    from scipy.io import wavfile

    from msmctts_tpu_torch import infer
    from msmctts_tpu_torch.serving import BatchingEngine, parse_phone_string
    from msmctts_tpu_torch.tools.load_test import percentiles

    # the daemon starts first; while its ranks start and warm up, the one-rank
    # references (each text alone, as the engine pads it) and infer
    proc, lines, t0 = _start_daemon("-m", am_path, "--port", "0", "--batch-size", str(SERVE_B), "--max-frames",
                                    str(SERVE_MAX_FRAMES), "--stream-chunk-frames", str(SERVE_CHUNK),
                                    "--mesh-devices", str(WORLD), "--devices", ",".join(["0"] * WORLD),
                                    "--backend", BACKEND)
    task = _load_tts_task(am_path, "cuda")
    n_symbols = list(task.networks["predictor"].n_symbols)
    rng = np.random.default_rng(seed)
    texts = [_phone_string(_text(rng, [int(n)], n_symbols, int(n))[0])
             for n in rng.integers(SERVE_PHONES[0], SERVE_PHONES[1] + 1, GROUP_CLIENTS)]
    eng = BatchingEngine(task, sample_rate=task.samplerate, batch_size=SERVE_B, window_ms=0.0,
                         max_frames=SERVE_MAX_FRAMES, stream_chunk_frames=SERVE_CHUNK)
    alone = {t: task.predict(eng.batch_of([parse_phone_string(t)]))["wav"][0] for t in texts}
    del task, eng
    torch.cuda.empty_cache()

    requests = [(texts[i % len(texts)], i % GROUP_STREAM_EVERY == GROUP_STREAM_EVERY - 1) for i in range(GROUP_REQUESTS)]
    try:
        # infer --mesh-devices 2 against one process, the last batch padded
        tmp = tempfile.mkdtemp(prefix="msmctts_group_infer_")
        try:
            cases = {f"g{i}": {"text": t} for i, t in enumerate((texts * 2)[:GROUP_INFER_TEXTS])}
            test_list = os.path.join(tmp, "test.yaml")
            with open(test_list, "w") as f:
                yaml.safe_dump(cases, f)
            one_dir, two_dir = os.path.join(tmp, "one"), os.path.join(tmp, "two")
            common = ["-m", am_path, "-t", test_list, "-b", str(GROUP_INFER_B)]
            t1 = time.perf_counter()
            infer.main(common + ["-o", one_dir])
            one_s = time.perf_counter() - t1
            t1 = time.perf_counter()
            infer.main(common + ["-o", two_dir, "--mesh-devices", str(WORLD), "--devices", ",".join(["0"] * WORLD),
                                 "--backend", BACKEND])
            two_s = time.perf_counter() - t1
            files = sorted(os.listdir(one_dir))
            if files != sorted(os.listdir(two_dir)) or len([f for f in files if f.endswith(".wav")]) != GROUP_INFER_TEXTS:
                raise AssertionError(f"infer --mesh-devices {WORLD}: files {sorted(os.listdir(two_dir))} vs {files}")
            infer_err = 0.0
            for name in files:
                a, b = os.path.join(one_dir, name), os.path.join(two_dir, name)
                if name.endswith(".wav"):
                    x, y = wavfile.read(a)[1].astype(np.float64) / 32767.0, wavfile.read(b)[1].astype(np.float64) / 32767.0
                else:
                    x, y = np.load(a), np.load(b)
                if x.shape != y.shape:
                    raise AssertionError(f"infer --mesh-devices {WORLD}: {name} {y.shape} vs {x.shape}")
                infer_err = max(infer_err, float(np.abs(x - y).max()))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        log(f"[23] (a) infer of {GROUP_INFER_TEXTS} texts at -b {GROUP_INFER_B} (last batch padded to {WORLD} rows) over "
            f"{WORLD} ranks vs one process: {len(files)} files, max abs diff {infer_err:.3g}; {two_s:.1f}s vs {one_s:.1f}s "
            "(the ranks' start included)")
        if infer_err > AS_TOL:
            raise AssertionError(f"infer --mesh-devices {WORLD} differs from one process by {infer_err}")
        warm_line = _wait_for_line(lines, "warmup:", proc, SERVE_TIMEOUT_S, "[23]")
        serving_line = _wait_for_line(lines, "serving on", proc, 60, "[23]")
        port = int(serving_line.rsplit(":", 1)[1])
        ready_s = _arrival(lines, serving_line) - t0
        results = [None] * len(requests)

        def client(worker):
            for i in range(worker, len(requests), GROUP_CLIENTS):
                t, stream = requests[i]
                results[i] = _http(port, "POST", "/synthesize", {"text": t, "stream": stream})

        threads = [threading.Thread(target=client, args=(w,)) for w in range(GROUP_CLIENTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(SERVE_TIMEOUT_S)
        load_s = time.perf_counter() - t0
        if any(r is None for r in results):
            raise AssertionError("the group daemon's load did not finish")
        for _ in range(100):  # a streamed batch is counted once its worker call returns
            stats = json.loads(_http(port, "GET", "/stats")[1])
            if stats["requests"] >= len(requests):
                break
            time.sleep(0.05)
        if proc.poll() is not None:
            raise AssertionError(f"the group daemon died with {proc.returncode}")
    finally:
        _stop(proc, 60)  # the launcher kills its ranks on the way out
    worst = 0.0
    for (t, stream), (status, data, _, _) in zip(requests, results):
        if status != 200:
            raise AssertionError(f"group daemon (stream {stream}): {status} {data[:300]!r}")
        pcm = _pcm(data, stream) / 32767.0
        if pcm.shape != alone[t].shape or not np.abs(pcm).max() > 1e-3:
            raise AssertionError(f"group daemon: {pcm.shape} samples, in-process {alone[t].shape} (stream {stream})")
        worst = max(worst, float(np.abs(pcm - alone[t]).max()))
    blocking = [r[3] for (_, s), r in zip(requests, results) if not s]
    first = [r[2] for (_, s), r in zip(requests, results) if s]
    lat, ttfa = percentiles(blocking), percentiles(first)
    ranks = stats.get("ranks") or []
    log(f"[23] (a) serve --mesh-devices {WORLD} --devices {','.join(['0'] * WORLD)} --backend {BACKEND} on {card}: ready "
        f"{ready_s:.1f}s after its start (the references and infer ran meanwhile; {warm_line.strip()}); {GROUP_CLIENTS} clients x {len(requests)} requests ({len(first)} streamed) in {load_s:.2f} s, "
        f"{stats['batches']} batches; blocking p50 / p95 / p99 {lat['p50'] * 1e3:.1f} / {lat['p95'] * 1e3:.1f} / "
        f"{lat['p99'] * 1e3:.1f} ms (client clock), first audio p50 {ttfa['p50'] * 1e3:.1f} ms; served vs one rank's "
        f"predict of each text alone max abs err {worst:.3g}; /stats ranks {json.dumps(ranks)}, errors {stats['errors']}")
    if worst > AS_TOL or stats["errors"] or len(ranks) != WORLD or any(r["cold_shapes"] or r["kernel_builds"] for r in ranks):
        raise AssertionError(f"the group daemon: served vs in-process {worst}, /stats {stats}")

    return {"ready_s": ready_s, "load_s": load_s, "latency_s": lat, "ttfa_s": ttfa, "served_err": worst,
            "stats": stats, "warmup_line": warm_line.strip(), "infer_err": infer_err, "infer_s": [one_s, two_s]}


def rank_tensor_parallel(group, device, batch_np, reference_indices, save_dir):
    """Phase 10's AE steps over data 2 x model 2 (``rank_train``), then, in
    the same process, phase 12's first AM step."""
    out = rank_train(group, device, batch_np, reference_indices, TP_MESH, save_dir)
    torch.cuda.empty_cache()
    out["am"] = _am_tp_step(group)
    return out


def _am_tp_step(group):
    """Phase 12's first AM step over data 2 x model 2 on this rank's rows."""
    from msmctts_tpu_torch.data.loader import to_device
    from msmctts_tpu_torch.parallel import mesh, sharding
    from msmctts_tpu_torch.training.base_trainer import metrics_to_host

    trainer = _build_am_trainer("cuda", group=group, mesh_node=TP_MESH)
    n_symbols = list(trainer.config.task["predictor"]["n_symbols"])
    batch_np = _am_batch(np.random.default_rng(1234), n_symbols, AM_B, AM_TEXT, AM_FRAMES, AM_PHONES, AM_LENGTHS)
    batch = to_device(mesh.shard_rows(batch_np, trainer.rank, trainer.world), "cuda")
    torch.cuda.synchronize()
    mesh.barrier(group)
    mesh.reset_collective_counts()
    sharding.PAIR_REDUCES[0] = 0
    _reset_counts()
    t0 = time.perf_counter()
    metrics = metrics_to_host(trainer.train_step(batch, 1))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    out = {"metrics": metrics, "ms": ms, "launches": _counts(), "by_group": mesh.collective_counts(by_group=True),
           "pair_reduces": sharding.PAIR_REDUCES[0], "blocks": len(trainer._plan.modules),
           "kept_whole": sorted(trainer._plan.replicated)}
    return out


def phase_tensor_parallel(card, batch_np, reference, dp_train, am_res):
    """(b) tensor parallelism at full width against the one-rank runs."""
    import hashlib
    import shutil

    from msmctts_tpu_torch.utils.checkpoint import find_latest_checkpoint

    save_dir = os.path.join(SMOKE_DIR, "tp_ckpt")
    shutil.rmtree(save_dir, ignore_errors=True)
    res = _run_ranks(rank_tensor_parallel, TP_WORLD, BACKEND, batch_np, reference["indices"], save_dir)
    held = _hold_dp_training(res, reference, BACKEND, card, "[23]",
                             f"data {TP_MESH['data']} x model {TP_MESH['model']} ranks ({TRAIN_B // TP_MESH['data']} rows a block)",
                             tol=TP_TOL)
    pairs = res[0]["pairs"]
    per_step = []
    for r in res:
        for step, dp in zip(r["steps"], dp_train["collectives_per_step"]):
            gan = step["iteration"] > 2
            want_pairs = pairs["fft"] + (pairs["mrf"] if gan else 0)
            model = step["by_group"].get("model all_reduce", {}).get("calls", 0)
            data = step["by_group"].get("data all_reduce", {}).get("calls", 0)
            bcast = step["by_group"].get("model broadcast", {}).get("calls", 0)  # gradients per optimizer, metrics
            if step["pair_reduces"] != want_pairs or model != 2 * want_pairs + (3 * pairs["mrf"] if gan else 0) + 1 \
                    or bcast != (2 if gan else 1) + 1 or data != dp["all_reduce"]["calls"] \
                    or any(k.startswith("world") for k in step["by_group"]):
                raise AssertionError(f"tensor parallel step {step['iteration']}: pair reduces {step['pair_reduces']} "
                                     f"(paired blocks {want_pairs}), collectives {step['by_group']}, phase 10's {dp}")
    per_step = [{k: v for k, v in s["by_group"].items()} | {"pair_reduces": s["pair_reduces"]} for s in res[0]["steps"]]
    log(f"[23] (b) paired blocks split: {pairs['fft']} FFT (attention and ConvFFN) + {pairs['mrf']} MRF pairs of "
        f"{pairs['marked']} leaves the JAX rules mark (kept whole: {pairs['kept_whole']}); per step on rank 0: "
        f"{json.dumps(per_step)}; kernel 2's calls of the last step against plain on every rank: max sums err "
        f"{max(row['sums_max_abs_err'] for r in res for row in r['stats']):.3g}")

    # the checkpoint written under tensor parallelism, into one rank
    path = res[0]["checkpoint"] or find_latest_checkpoint(save_dir)
    t0 = time.perf_counter()
    one = _build_trainer("cuda", warmup_steps=2)
    one.load(path)
    digest = hashlib.sha256()
    for t in list(one.ae.state_dict().values()) + list(one.disc.state_dict().values()):
        digest.update(t.detach().cpu().numpy().tobytes())
    load_s = time.perf_counter() - t0
    size_mb = os.path.getsize(path) / 1e6
    del one
    shutil.rmtree(save_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"[23] (b) the checkpoint written under tensor parallelism ({size_mb:.1f} MB, saved in "
        f"{res[0]['save_s']:.2f}s after the gathers) loads into one rank in {load_s:.2f}s: bit-equal to the gathered "
        f"state {digest.hexdigest() == res[0]['digest']}")
    if digest.hexdigest() != res[0]["digest"]:
        raise AssertionError("the tensor-parallel checkpoint does not load into one rank as the gathered state")

    # one AM step at batch 64, bucket 768, against phase 12's first step
    am = [r["am"] for r in res]
    want = am_res["steps"][0]["metrics"]
    worst = 0.0
    for r in am:
        if r["metrics"] != am[0]["metrics"] or r["launches"] != {"vq_nearest": 2, "vq_nearest_stats": 0,
                                                                  "fused_resblock_layer": 0}:
            raise AssertionError(f"tensor parallel AM step: metrics or launches differ: {r['launches']}")
        if r["pair_reduces"] != r["blocks"]:
            raise AssertionError(f"tensor parallel AM step: {r['pair_reduces']} pair reduces for {r['blocks']} blocks")
    for k, w in want.items():
        worst = max(worst, abs(am[0]["metrics"][k] - w) / max(abs(w), 1e-3))
    log(f"[23] (b) AM step at batch {AM_B} (bucket {AM_FRAMES}) over data 2 x model 2: {am[0]['blocks']} paired blocks "
        f"split (kept whole: {am[0]['kept_whole']}), pair reduces {am[0]['pair_reduces']}, collectives "
        f"{json.dumps(am[0]['by_group'])}, launches per rank {am[0]['launches']}; metrics vs phase 12's first step worst "
        f"relative {worst:.3g}; wall per rank {[round(r['ms'], 1) for r in am]} ms ({TP_WORLD} processes time-slicing "
        f"{card} over gloo; phase 12's first step {am_res['first_ms']:.1f} ms, warm {am_res['warm_ms']:.1f} ms)")
    if worst > STEP_TOL["loss_rtol"]:
        raise AssertionError(f"tensor parallel AM step differs from phase 12's by {worst} relative")
    return {**held, "pairs": pairs, "collectives_rank0": per_step, "stats": res[0]["stats"],
            "checkpoint_mb": size_mb, "checkpoint_load_s": load_s,
            "am": {"metrics_rel": worst, "ms": [r["ms"] for r in am],
                   "collectives": am[0]["by_group"], "pair_reduces": am[0]["pair_reduces"]},
            "launches_stats_per_rank": sum(s["launches"]["vq_nearest_stats"] for s in res[0]["steps"]),
            "ae_ms": [[s["ms"] for s in r["steps"]] for r in res]}


def phase_group(card, am_path, batch_np, reference, dp_train, am_res):
    return {"serving": phase_group_serving(card, am_path),
            "tensor_parallel": phase_tensor_parallel(card, batch_np, reference, dp_train, am_res)}


# --------------------------------------------------------------- phase 24
# the benchmark's train limits (perfbench/workloads/csmsc_ae.gan_step_b16.json)
GRAPH_LIMITS = {"loss_gap": 1.2e-4, "grad_gap": 7e-4, "change_gap": 4e-3}
GRAPH_STEPS = 3
GRAPH_FRAMES = 1024  # the CSMSC cell's frame bucket


def _tiny_ae_config():
    """The CPU tests' tiny autoencoder recipe (``tests/tiny.py``: mel dim 8,
    frameshift 4, 2 stages of 2 heads, dropout 0.1), GAN steps from the first."""
    from msmctts_tpu_torch.config import Config

    fft = {"max_seq_len": 64, "n_layers": 1, "n_head": 2, "d_k": 8, "d_v": 8, "d_inner": 32, "dropout": 0.1,
           "attn_dropout": 0.0}
    return Config({
        "task": {"_name": "MSMCTTS", "_mode": "train_autoencoder",
                 "autoencoder": {"_name": "MSMCVQGAN", "in_dim": 8, "n_model_size": 16, "pred_mel": True,
                                 "encoder_config": {"downsample_scales": [1, 2], **fft},
                                 "quantizer_config": {"embedding_sizes": 8, "embedding_dims": 16, "n_heads": 2,
                                                      "prior_config": {"kernel_size": 3, "dilation_rate": 1,
                                                                       "n_layers": 1}},
                                 "frame_decoder_config": dict(fft),
                                 "decoder_config": {"upsample_rates": [2, 2], "upsample_kernel_sizes": [4, 4],
                                                    "upsample_initial_channel": 16, "resblock_kernel_sizes": [3],
                                                    "resblock_dilation_sizes": [[1, 3]]}},
                 "discriminator": {"_name": "UnivNetDiscriminator",
                                   "mrd_config": {"hop_lengths": [4, 8], "hidden_channels": [32, 32],
                                                  "domain": "double", "mel_scale": True, "sample_rate": 1600},
                                   "mpd_config": {"periods": [2, 3], "channels": 4, "max_channels": 16}}},
        "trainer": {"_name": "VQGANTrainer", "grad_clip_thresh": 1.0, "warmup_steps": 0, "sample_lengths": 32,
                    "lambda_vq": 1, "lambda_pr": 0.1, "lambda_frame": 10, "lambda_fm": 2, "lambda_stft": 4.5,
                    "stft_loss_config": {"fft_size": 64, "hop_size": 16, "win_size": 64, "num_mels": 8}},
        "optimizer": {"_default": {"_name": "AdamW", "learning_rate": 2e-4, "betas": [0.8, 0.99], "eps": 1e-8,
                                   "weight_decay": 0.0}},
        "dataset": {"_name": "MelDataset", "samplerate": 1600, "feature": ["mel", "wav"],
                    "dimension": [8, 1], "frameshift": [4, 1], "padding_value": [-4, 0]},
        "seed": 1234, "save_checkpoint_dir": os.path.join(SMOKE_DIR, "ckpt_tiny"),
    })


def _graph_batches(trainer, B, T, lo, hi, seed):
    """``GRAPH_STEPS`` seeded batches of B rows in frame bucket T (lengths
    in [lo, hi], padded as the loader pads), each with its window starts."""
    from msmctts_tpu_torch.data.loader import to_device

    ds = trainer.config.dataset
    mel = list(ds["feature"]).index("mel")
    n_mel, shift = ds["dimension"][mel], ds["frameshift"][mel]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(GRAPH_STEPS):
        lengths = rng.integers(lo, hi + 1, size=B)
        batch = to_device(_train_batch(rng, lengths, T, n_mel, shift), "cuda")
        starts = np.floor(rng.random(B) * np.maximum(lengths - trainer.frame_lengths, 1)).astype(np.int64)
        out.append((batch, torch.as_tensor(starts, device="cuda")))
    return out


def _graph_turns(trainer, batches, tag, what):
    """From the trainer's state now, the benchmark's checked steps three
    times, each after the benchmark's restore (the weights loaded in place,
    each optimizer's state before any update, the generator's state):
    eager, graphed (the capture and two replays; one step at the shape, its
    first sight, goes before the turns) and graphed again (replays alone).
    Every dropout mask is recorded (``Tensor.bernoulli_``; a captured mask
    is held, which the graphs' memory includes, and read after each replay
    of its graph)."""
    import copy

    from msmctts_tpu_torch.utils import graphs, tracing
    from perfbench.reference.judge_train import compare, norms, on_host

    nets = {"autoencoder": trainer.ae, "discriminator": trainer.disc}
    known = ({n: {k: v.detach().clone() for k, v in m.state_dict().items()} for n, m in nets.items()},
             {n: copy.deepcopy(o.state_dict()) for n, o in trainer.optimizers.items()},
             trainer.generator.get_state())
    masks, captured, draw = [], [], torch.Tensor.bernoulli_

    def recorded(self, *args, **kwargs):
        out = draw(self, *args, **kwargs)
        masks.append(out)
        return out

    def turn(graphed):
        for n, m in nets.items():
            m.load_state_dict(known[0][n])
        for n, o in trainer.optimizers.items():
            o.load_state_dict(copy.deepcopy(known[1][n]))
        trainer.generator.set_state(known[2])
        losses, first_grad, step_masks, ms = [], {}, [], []
        available = graphs.available
        if not graphed:
            graphs.available = lambda device: False
        try:
            for i, (batch, starts) in enumerate(batches, start=1):
                n0 = len(masks)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = trainer.train_step(batch, i, starts=starts)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                new = masks[n0:]
                del masks[n0:]
                if new:  # drawn by this step (eager, or captured: then held), else by the replay of the captured
                    captured[:] = new
                step_masks.append([x.bool().cpu() for x in captured])
                losses.append({k: float(m[k]) for k in ("g_loss", "d_loss")})
                if i == 1:
                    grads = {}
                    for group, opt in trainer.optimizers.items():
                        beta1 = opt.opt.param_groups[0]["betas"][0]
                        for name, p in nets[group].named_parameters():
                            st = opt.opt.state.get(p, {})
                            if "exp_avg" in st:
                                grads[f"{group}.{name}"] = st["exp_avg"] / (1.0 - beta1)
                    first_grad = {"first_grad": norms(grads), "grad": on_host(grads)}
        finally:
            graphs.available = available
        change = on_host({f"{n}.{k}": v - known[0][n][k] for n, m in nets.items() for k, v in m.state_dict().items()
                          if v.is_floating_point()})
        return {"losses": losses, **first_grad, "change": change, "masks": step_masks, "ms": ms}

    batch, starts = batches[0]
    trainer.train_step(batch, 1, starts=starts)  # the shape's first sight: eager
    torch.Tensor.bernoulli_ = recorded
    try:
        tracing.clear()
        torch.cuda.reset_peak_memory_stats()
        eager = turn(False)
        peak_eager = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        held0, reserved0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        graphed = turn(True)
        peak_graphed = torch.cuda.max_memory_allocated()
        mask_bytes = sum(x.numel() * x.element_size() for x in captured)
        held = torch.cuda.memory_allocated() - held0 - mask_bytes  # the graphs' live tensors, the masks left out
        reserved = torch.cuda.memory_reserved() - reserved0
        again = turn(True)
    finally:
        torch.Tensor.bernoulli_ = draw
    captures = [s.attrs for s in tracing.spans() if s.name == "train.capture"]
    steps = [s.attrs["graphed"] for s in tracing.spans() if s.name == "train.step"]
    if len(captures) != 1 or steps != [0] * GRAPH_STEPS + [1] * (2 * GRAPH_STEPS):
        raise AssertionError(f"{tag} {what}: captures {captures}, graphed steps {steps}: one capture per shape, "
                             f"every graphed turn's step graphed")
    n_masks = [len(x) for x in eager["masks"]]
    same_masks = [all(torch.equal(a, b) for a, b in zip(e, g)) and len(e) == len(g)
                  for e, g in zip(eager["masks"], graphed["masks"])]
    same_again = [all(torch.equal(a, b) for a, b in zip(e, g)) for e, g in zip(graphed["masks"], again["masks"])]
    if not (all(same_masks) and all(same_again)):
        raise AssertionError(f"{tag} {what}: dropout masks differ from eager's (per step {same_masks}, "
                             f"again {same_again})")
    vs_eager = compare(graphed, eager)
    vs_first = compare(again, graphed)
    bitwise = graphed["losses"] == again["losses"] and all(
        torch.equal(graphed["change"][k], again["change"][k]) for k in graphed["change"])
    res = {"masks_per_step": n_masks, "graphed_vs_eager": vs_eager, "again_vs_graphed": vs_first,
           "again_bitwise": bitwise, "losses": {"eager": eager["losses"], "graphed": graphed["losses"],
                                                "again": again["losses"]},
           "step_ms": {"eager": eager["ms"], "graphed": graphed["ms"], "again": again["ms"]},
           "capture": captures[0], "peak_gb": {"eager": peak_eager / 1e9, "graphed": peak_graphed / 1e9},
           "held_by_graphs_gb": held / 1e9, "recorded_masks_gb": mask_bytes / 1e9,
           "reserved_by_capture_gb": reserved / 1e9}
    log(f"{tag} {what}: {sum(n_masks)} masks in {GRAPH_STEPS} steps equal eager's; graphed vs eager "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in vs_eager.items()})}; after the restore vs the first "
        f"graphed {json.dumps({k: float(f'{v:.3g}') for k, v in vs_first.items()})} (bit-equal: {bitwise}); "
        f"step ms eager {[round(x, 1) for x in eager['ms']]}, graphed {[round(x, 1) for x in graphed['ms']]}, "
        f"again {[round(x, 1) for x in again['ms']]}; peak {peak_eager / 1e9:.2f} GB eager, "
        f"{peak_graphed / 1e9:.2f} GB graphed (with the recorded masks, {mask_bytes / 1e9:.2f} GB); the graphs' "
        f"tensors {held / 1e9:.2f} GB besides, {reserved / 1e9:.2f} GB more reserved by the capture; capture "
        f"{captures[0]}")
    for name, got in (("graphed vs eager", vs_eager), ("again vs graphed", vs_first)):
        over = {k: v for k, v in got.items() if v > GRAPH_LIMITS[k]}
        if over:
            raise AssertionError(f"{tag} {what}: {name} over the benchmark's train limits: {over}")
    return res


def _graph_times(trainer, batch, starts, runs=8):
    """Median step ms, graphed (replays) and eager, in turns, after the turns
    above (the trainer moves on: the times alone are read)."""
    from msmctts_tpu_torch.utils import graphs

    def once(i):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch, i, starts=starts)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    available, times = graphs.available, {"graphed": [], "eager": []}
    try:
        for turn in range(4):
            side = "eager" if turn % 2 else "graphed"
            graphs.available = (lambda device: False) if side == "eager" else available
            once(100 + turn)  # settle after the switch
            times[side] += [once(101 + turn) for _ in range(runs // 2)]
    finally:
        graphs.available = available
    return {k: statistics.median(v) for k, v in times.items()}, times


def phase_train_graphs(card):
    """Phase 24: CUDA graphs of the GAN step (``utils/graphs.py``), at the
    tiny width and at the CSMSC recipe's (batch 16, frame bucket 1024, 0.5 s
    windows, the recipe's dropout): the benchmark's checked steps eager,
    graphed and graphed again after its restore, held to the benchmark's
    train limits and to eager's dropout masks; then step times in turns.
    The same turns for the other recipes that reach the GAN step (the ISTFT
    decoder, the quantizer's options with batch norm and restarts, LJSpeech)
    at batch 4 in frame bucket 256, on seeded weights."""
    from msmctts_tpu_torch.config import component_kwargs
    from msmctts_tpu_torch.registry import get_trainer
    from msmctts_tpu_torch.tasks import build_task

    cfg = _tiny_ae_config()
    task = build_task(cfg, device="cuda", mode="train")
    tiny = get_trainer(cfg.trainer["_name"])(cfg, task, **component_kwargs(cfg.trainer))
    tiny.init_state()
    tiny_batches = _graph_batches(tiny, 4, 32, 16, 32, seed=24)
    out = {"tiny": _graph_turns(tiny, tiny_batches, "[24]", "tiny width, B=4, 32 frames")}
    out["tiny"]["median_ms"], _ = _graph_times(tiny, *tiny_batches[0])
    del tiny, task

    csmsc = _build_trainer("cuda", warmup_steps=0)
    batches = _graph_batches(csmsc, TRAIN_B, GRAPH_FRAMES, 120, 800, seed=2024)
    what = f"CSMSC recipe, B={TRAIN_B}, {GRAPH_FRAMES} frames, windows of {csmsc.sample_lengths} samples"
    out["csmsc"] = _graph_turns(csmsc, batches, "[24]", what)
    medians, runs = _graph_times(csmsc, *batches[0])
    out["csmsc"].update(median_ms=medians, runs_ms=runs)
    log(f"[24] {what} on {card}: median step {medians['graphed']:.1f} ms graphed, {medians['eager']:.1f} ms eager "
        f"(runs {json.dumps({k: [round(x, 1) for x in v] for k, v in runs.items()})})")
    del csmsc, batches
    for name, path, quantizer in (("istft", ISTFT_YAML, None), ("options", AE_YAML, OPTIONS),
                                  ("ljspeech", LJ_AE_YAML, None)):
        cfg = _recipe_config(path, os.path.join(SMOKE_DIR, f"ckpt_graphs_{name}"), warmup_steps=0, quantizer=quantizer)
        trainer = _seeded_trainer(cfg, "cuda")
        out[name] = _graph_turns(trainer, _graph_batches(trainer, 4, 256, 64, 256, seed=24), "[24]",
                                 f"{name} recipe, B=4, 256 frames")
        del trainer
    return out


def _device_rows(prof):
    """[{name, count, device_ms}] of a profile's kernels, the longest first."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:  # host ops also carry their kernels' time
            continue
        if getattr(ev, "is_user_annotation", False):
            continue  # an annotation's span on the device timeline (Optimizer.step#...) covers kernels counted below
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0 and ev.count > 0:
            rows.append({"name": ev.key[:120], "count": ev.count, "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    return rows


def profile_call(fn, tag, what, shown=12):
    """Device time by kernel name over one warm call of ``fn``, and the
    card's busy share of its wall time (torch.profiler); logs the ``shown``
    longest kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(prof)
    busy_ms = sum(r["device_ms"] for r in rows)
    log(f"{tag} profiled {what}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({busy_ms / wall_ms:.0%}), {sum(r['count'] for r in rows)} kernels")
    for r in rows[:shown]:
        log(f"{tag}   {r['device_ms']:8.3f} ms  x{r['count']:<4d} {r['name']}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "kernels": rows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also profile one predict, one GAN step, one AM step, a streamed batch, phase 14's "
                         "analysis-synthesis, GAN step and predictor step, phase 15's analysis-synthesis and GAN step, "
                         "phase 16's int8 decode and phase 17's QAT step, and write every measurement to this JSON file")
    ap.add_argument("--feed-ab", action="store_true",
                    help="run only the feed's A/B: warm AE steps through train() with the default feed, no "
                         "prefetch, the loop's feed before the prefetcher and prefetch without the wire, in turns "
                         "(no kernel line, no last line)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import msmctts_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    t_start = time.perf_counter()
    spent = {}  # seconds per phase, by phase number

    def timed(phase, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        spent[phase] = round(spent.get(phase, 0.0) + time.perf_counter() - t0, 1)
        gc.collect()  # a phase's trainers and their CUDA graphs go before the next phase allocates
        log(f"[time] phase {phase} {spent[phase]}s, {time.perf_counter() - t_start:.1f}s since the start")
        return out

    gen = torch.Generator(device="cuda").manual_seed(0)
    env = timed("1", phase_environment)
    if args.feed_ab:
        feed_ab(env["nvidia_smi"])
        log(f"[end] wall {time.perf_counter() - t_start:.1f}s on {env['nvidia_smi']}")
        return 0
    build = timed("2", phase_build)
    vq_res = timed("3", phase_vq, gen)
    vqs_res = timed("3", phase_vq_stats, gen)
    rb_res = timed("3", phase_resblock, gen)
    as_res = timed("4", phase_analysis_synthesis)
    tts_res, predict, tts_ref = timed("5", phase_text_to_wav, env["nvidia_smi"])
    profile = profile_call(predict, "[5]", "predict") if args.out else None
    del predict
    train_res, train_ref = timed("6", phase_training, env["nvidia_smi"], with_profile=bool(args.out))
    backend = BACKEND
    log(f"[8] {WORLD} ranks share cuda:0; collectives over backend {backend}")
    batch_np = _training_batch()[0]
    ranks = timed("8-11 ranks", phase_two_ranks, backend, batch_np, train_ref, tts_ref)
    # phase 9's process runs beside phase 7 and the holds of phases 8, 10 and 11, which time nothing
    nccl = _Beside(phase_nccl, batch_np)
    step_res = timed("7", phase_step_card_vs_cpu)
    shard_res = timed("8", phase_sharded_kernels, ranks["sharded"], backend, env["nvidia_smi"])
    dp_train = timed("10", phase_dp_training, ranks["train"], backend, train_ref, env["nvidia_smi"])
    dp_infer = timed("11", phase_dp_inference, ranks["predict"], backend, tts_ref)
    del ranks
    nccl_res = nccl.result()
    spent["9"] = round(nccl.seconds, 1)
    log(f"[time] phase 9 {spent['9']}s beside phases 7, 8, 10 and 11, {time.perf_counter() - t_start:.1f}s since the start")
    am_res = timed("12", phase_am_training, env["nvidia_smi"], with_profile=bool(args.out))
    am_cpu = timed("12", phase_am_step_card_vs_cpu)
    am_cli = timed("12", phase_am_entry_point, env["nvidia_smi"])
    t_serving = time.perf_counter()
    serving = timed("13", phase_serving, env["nvidia_smi"], tts_ref["am_path"], with_profile=bool(args.out))
    serving["phase_s"] = time.perf_counter() - t_serving
    log(f"[13] serving phase {serving['phase_s']:.1f}s")
    qs = timed("14", phase_qs_tts, gen, env["nvidia_smi"], with_profile=bool(args.out))
    istft = timed("15", phase_istft, gen, env["nvidia_smi"], with_profile=bool(args.out))
    int8 = timed("16", phase_int8, env["nvidia_smi"], tts_ref["am_path"], with_profile=bool(args.out))
    tools = timed("17", phase_quality_tools, gen, env["nvidia_smi"], with_profile=bool(args.out))
    lj = timed("18", phase_ljspeech, gen, env["nvidia_smi"])
    bf16 = timed("19", phase_bf16, env["nvidia_smi"], tts_ref["am_path"], tts_ref)
    opts = timed("20", phase_options, env["nvidia_smi"], tts_ref)
    fx = timed("21", phase_feed_and_export, env["nvidia_smi"], tts_ref["am_path"], tts_ref)
    fx_feed, fx_exp = fx["feed"], fx["export"]
    ob = timed("22", phase_orbax, env["nvidia_smi"], tts_ref["am_path"])
    grp = timed("23", phase_group, env["nvidia_smi"], tts_ref["am_path"], batch_np, train_ref, dp_train, am_res)
    graphs_res = timed("24", phase_train_graphs, env["nvidia_smi"])
    ob_tr, ob_sv = ob["training"], ob["serving"]
    grp_tp = grp["tensor_parallel"]
    bf_vq, bf_am, bf_inf = bf16["vqgan"], bf16["am"], bf16["inference"]
    o_i8, o_tr, o_tts = opts["int8_bf16"], opts["training"], opts["legacy_tts"]
    lj_as, lj_tr, lj_tools, lj_daemon = lj["analysis_synthesis"], lj["training"], lj["tools"], lj["daemon"]
    t_qat, t_mcd, t_dbg, t_eval = tools["qat"], tools["as_mcd"], tools["debug"], tools["evaluate"]
    launches_qat = lambda key: {"precompute": t_qat["launches_precompute"][key], "sweep_fp32": t_mcd["launches"][key],
                                "debug_step": t_dbg["launches"][key], "evaluate": t_eval["launches"][key]}
    ist_as, ist_tr, ist_pr = istft["analysis_synthesis"], istft["training"], istft["predict"]
    ist_snap = lambda rows: [{k: r[k] for k in ("N", "device_ms", "ms", "plain_ms", "bound_ms", "bound_by", "index_mismatches",
                                               "max_abs_err")} for r in rows]
    qs_snap = lambda rows: [{k: r[k] for k in ("N", "device_ms", "ms", "plain_ms", "bound_ms", "bound_by", "index_mismatches",
                                              "max_abs_err")} for r in rows]
    qs_as, qs_pred = qs["analysis_synthesis"], qs["predictor_training"]
    qs_stats_n = f"N={QS_TRAIN_B * QS_TRAIN_FRAMES // 4} + N={QS_TRAIN_B * QS_TRAIN_FRAMES}"

    kernels = [
        {
            "name": "vq_nearest", "route": "cuda", "source": "msmctts_tpu_torch/csrc/vq_nearest.cu",
            "replaces": "msmctts_tpu/ops/pallas_vq.py:160", "launches": tts_res["launches"]["vq_nearest"],
            "max_abs_err": vq_res["max_abs_err"], "ms": vq_res["ms"], "plain_ms": vq_res["plain_ms"],
            "bound_ms": vq_res["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "device_ms": vq_res["device_ms"],  # the kernel alone; ms is events around the wrapper's calls
            "tolerance": VQ_TOL, "shapes": "per predict: 2 x N=512 + 2 x N=2048, H=4, d=64, K=64",
            # the acoustic-model train step: the frozen teacher's snap, one launch per stage
            "launches_am_step": am_res["launches_per_step"]["vq_nearest"],
            "am_step": [{k: r[k] for k in ("N", "device_ms", "ms", "plain_ms", "bound_ms", "bound_by", "index_mismatches")}
                        for r in am_res["snap"]],
            # serving: one streamed batch (predict_features), and the kernel at its N
            "launches_serving": serving["stream"]["launches"]["vq_nearest"],
            "serving": {**serving["snap"], "frame_bucket": serving["stream"]["frame_bucket"]},
            # QS-TTS: the synthesizer's analysis-synthesis (per batch of 4 at bucket 512) and
            # the predictor step's frozen teacher (batch 64, bucket 768)
            "launches_qs_tts": {"analysis_synthesis_batch": qs_as["launches"]["vq_nearest"],
                                "predictor_step": qs_pred["launches_per_step"]["vq_nearest"]},
            "qs_tts": {"analysis_synthesis": qs_snap(qs_as["snap"]), "predictor_step": qs_snap(qs_pred["snap"])},
            # the ISTFT recipe: analysis-synthesis (B=4, bucket 512) and predict over its autoencoder;
            # the int8 decoder's predict (the decoder runs no VQ: the same 4 snaps)
            "launches_istft": {"analysis_synthesis_batch": ist_as["launches"]["vq_nearest"],
                               "predict_batch": ist_pr["launches"]["vq_nearest"]},
            "istft": {"analysis_synthesis": ist_snap(ist_as["snap"])},
            "launches_int8": {"analysis_synthesis_batch": int8["decoder"]["launches"]["vq_nearest"],
                              "predict_batch": int8["serving"]["predict"]["launches"]["vq_nearest"]},
            # phase 17: the QAT precompute (16 utterances, one at a time), the sweep's fp32 run
            # (2 snapshots x 2 batches), one debug_step (B=2), one evaluate (one row)
            "launches_qat": launches_qat("vq_nearest"),
            "qat": {"precompute": ist_snap(t_qat["snap"]), "debug_step": ist_snap(t_dbg["snap"])},
            # phase 18, the LJSpeech recipes: analysis-synthesis (B=4, bucket 512), predict of one
            # utterance at the static bucket of synthesize --static-frames 512, the daemon's batch
            # of 8 at bucket 512 (N = 1024 and 4096, on that batch's inputs)
            "launches_ljspeech": {"analysis_synthesis_batch": lj_as["launches"]["vq_nearest"],
                                  "predict": lj_tools["synthesize_launches"]["vq_nearest"],
                                  "daemon_batch": lj_daemon["batch_launches"]["vq_nearest"]},
            "ljspeech": {"analysis_synthesis": ist_snap(lj_as["snap"]), "daemon_batch": ist_snap(lj_daemon["snap"])},
            # phase 19, precision: bfloat16: the bf16 AM step's teacher (2 a step) and a bf16 predict (4),
            # each launch held against plain on its inputs
            "launches_bf16": {"am_step": 2, "predict_batch": bf_inf["launches"]["vq_nearest"]},
            "bf16": {"am_step": bf_am["snap"], "predict": bf_inf["snap"]},
            # phase 20: bf16 --int8 on the fixture (analysis-synthesis B=4, predict B=4), the options' checkpoint
            # through analysis-synthesis in both learned upsampling modes, the legacy TTS task's autoencoder
            # ending; every launch held against plain on its inputs
            "launches_options": {"int8_bf16_analysis_synthesis_batch": o_i8["launches"]["vq_nearest"],
                                 "int8_bf16_predict_batch": o_i8["predict_launches"]["vq_nearest"],
                                 **{f"{m}_analysis_synthesis_batch": o_tr["modes"][m]["launches"]["vq_nearest"]
                                    for m in o_tr["modes"]},
                                 "legacy_tts_autoencoder_batch": o_tts["autoencoder"]["launches"]["vq_nearest"]},
            "options": {"int8_bf16": o_i8["snaps"] + o_i8["predict_snaps"],
                        **{m: o_tr["modes"][m]["snaps"] for m in o_tr["modes"]},
                        "legacy_tts": o_tts["autoencoder"]["snaps"]},
            # phase 21: phase 5's batch through the exported programs (fp32 and int8, B=4, text bucket
            # 128, 512 frames), every launch through the msmctts::vq_nearest operator, held against plain
            "launches_export": {"fp32_artifact_batch": fx_exp["launches"]["vq_nearest"],
                                "int8_artifact_batch": fx_exp["int8"]["launches"]["vq_nearest"]},
            # phase 12's train entry point: 2 AM steps behind the feed's prefetcher, the teacher's snaps
            "launches_feed": {"am_train_2_steps": am_cli["train_launches"]["vq_nearest"]},
            "export": {"fp32": fx_exp["snaps"], "int8": fx_exp["int8"]["snaps"]},
            # phase 22: infer -m <snapshot> (phase 5's serving weights as orbax snapshots), one batch of 4,
            # every launch held against plain on its inputs
            "launches_orbax": {"infer_snapshot_batch": ob_sv["launches"]["vq_nearest"]},
            "orbax": ob_sv["snaps"],
        },
        {
            "name": "vq_nearest_stats", "route": "cuda", "source": "msmctts_tpu_torch/csrc/vq_stats.cu",
            "replaces": "msmctts_tpu/ops/pallas_vq.py:88", "launches": train_res["launches"]["vq_nearest_stats"],
            "max_abs_err": vqs_res["max_abs_err"], "ms": vqs_res["ms"], "plain_ms": vqs_res["plain_ms"],
            "bound_ms": vqs_res["bound_ms"], "bound_by": vqs_res["bound_by"], "library_ms": None,
            "device_ms": vqs_res["device_ms"], "beyond_snap_ms": vqs_res["beyond_snap_ms"],
            "tolerance": {"idx_quant_counts": "exact", "sums": VQS_TOL},
            "shapes": f"per train step: N={TRAIN_B * TRAIN_FRAMES // 4} + N={TRAIN_B * TRAIN_FRAMES}, H=4, d=64, K=64; "
                      "launches over 2 warmup + 2 GAN steps",
            "launches_qs_tts": qs["training"]["launches_per_step"]["vq_nearest_stats"],
            "qs_tts_shapes": f"per QS-TTS synthesizer train step (batch 16, bucket 384): {qs_stats_n}, H=4, d=64, K=64",
            # both calls of one QS-TTS train step on the inputs the path gave them, against the plain version
            "qs_tts": [{k: r[k] for k in ("N", "valid", "walkers", "device_ms", "ms", "plain_ms", "bound_ms", "bound_by",
                                          "sums_max_abs_err")} for r in qs["training"]["stats"]],
            # the ISTFT recipe's train step (batch 16, bucket 400), both calls on the path's inputs
            "launches_istft": ist_tr["launches_per_step"]["vq_nearest_stats"],
            "istft": [{k: r[k] for k in ("N", "valid", "walkers", "device_ms", "ms", "plain_ms", "bound_ms", "bound_by",
                                         "sums_max_abs_err")} for r in ist_tr["stats"]],
            # the LJSpeech recipe's train step (batch 16, bucket 400), both calls on the path's inputs, and
            # the kernels the train CLI's --profile trace names over its steps 10-14
            "launches_ljspeech": lj_tr["launches_per_step"]["vq_nearest_stats"],
            "ljspeech": [{k: r[k] for k in ("N", "valid", "walkers", "device_ms", "ms", "plain_ms", "bound_ms", "bound_by",
                                            "sums_max_abs_err")} for r in lj_tr["stats"]],
            "ljspeech_profile_kernels": lj["profile"]["vq_stats_kernels"],
            # phase 19: the bf16 AE step (fp32 rows: the quantizer's input promotes), both calls on the path's inputs
            "launches_bf16": 2,
            "bf16": [{k: r[k] for k in ("N", "valid", "device_ms", "ms", "plain_ms", "bound_ms", "sums_max_abs_err")}
                     for r in bf_vq["stats"]],
            # phase 20: the CSMSC AE recipe with norm: True, residual upsampling and restart_dead (batch 16,
            # bucket 400), both calls of one step on the path's inputs
            "launches_options": o_tr["training"]["launches_per_step"]["vq_nearest_stats"],
            "options": [{k: r[k] for k in ("N", "valid", "device_ms", "ms", "plain_ms", "bound_ms", "sums_max_abs_err")}
                        for r in o_tr["training"]["stats"]],
            # phase 21: the AE recipe's steps through train() behind the prefetcher and the wire format
            # (batch 16 from the feed corpus, 1 warmup + 4 GAN steps a run), the last step's two calls
            # against plain on their inputs
            "launches_feed": fx_feed["launches_per_run"]["vq_nearest_stats"],
            "feed": fx_feed["stats"],
            # phase 22: train() of the AE recipe with checkpoint_backend: orbax (1 warmup + 1 GAN step at
            # batch 16), then one GAN step after the orbax resume, its two calls against plain on their inputs
            "launches_orbax": {"train_2_steps": ob_tr["launches_train"]["vq_nearest_stats"],
                               "resumed_gan_step": ob_tr["launches_resumed_step"]["vq_nearest_stats"]},
            "orbax": ob_tr["stats"],
        },
        {
            "name": "vq_nearest_stats_sharded", "route": "cuda", "source": "msmctts_tpu_torch/csrc/vq_stats.cu",
            "replaces": "msmctts_tpu/ops/pallas_vq.py:212", "launches": dp_train["sharded_launches"],
            "max_abs_err": shard_res["max_err_vs_plain"], "ms": shard_res["stats_sharded_ms"],
            "plain_ms": shard_res["stats_sharded_plain_ms"],
            "bound_ms": shard_res["stats_kernel_bound_ms"] + 2 * shard_res["all_reduce_link_bound_ms"],
            "bound_by": shard_res["stats_bound_by"], "library_ms": None,
            "kernel_ms": shard_res["stats_kernel_ms"], "all_reduce_ms": shard_res["all_reduce_ms"],
            "device_ms": vqs_res["rank_rows"]["stats_per_step_ms"],
            "all_reduce_bytes": shard_res["all_reduce_bytes"], "backend": backend, "world": WORLD,
            "max_abs_err_vs_one_rank": shard_res["max_err_vs_one_rank"],
            "tolerance": {"idx_quant_counts": "exact", "sums": VQS_TOL, "across_ranks": "bit-equal"},
            "shapes": f"per train step per rank of {WORLD} sharing one card: n={shard_res['stats_rows']} rows, H=4, d=64, K=64, each "
                      "followed by one all-reduce; ms is kernel + collective on the host clock; the bound adds the two "
                      "all-reduces over one NVLink direction (not measured: one card); launches per rank over 2 warmup + 2 GAN steps",
            # the QS-TTS synthesizer's quantizer calls this function; on one card with no group
            "launches_qs_tts": qs["training"]["launches_per_step"]["vq_nearest_stats"],
            "qs_tts_shapes": f"per QS-TTS synthesizer train step on one rank, no group (no all-reduce): {qs_stats_n}",
            # the ISTFT and LJSpeech recipes' quantizers call this function too, with no group
            "launches_istft": ist_tr["launches_per_step"]["vq_nearest_stats"],
            "launches_ljspeech": lj_tr["launches_per_step"]["vq_nearest_stats"],
            # phase 23 (b): tensor parallelism, data 2 x model 2 on 4 ranks of the one card: the sums
            # reduced over the data group only; launches per rank over 2 warmup + 2 GAN steps, the last
            # step's two calls on every rank held against plain on their inputs (8 rows a rank)
            "launches_tensor_parallel": grp_tp["launches_stats_per_rank"],
            "tensor_parallel": [{k: r[k] for k in ("N", "valid", "bound_ms", "sums_max_abs_err", "index_ties")}
                                for r in grp_tp["stats"]],
        },
        {
            "name": "vq_nearest_sharded", "route": "cuda", "source": "msmctts_tpu_torch/csrc/vq_nearest.cu",
            "replaces": "msmctts_tpu/ops/pallas_vq.py:273", "launches": dp_infer["launches"]["vq_nearest"],
            "max_abs_err": shard_res["snap_err_vs_plain"], "ms": shard_res["snap_kernel_ms"], "plain_ms": shard_res["snap_plain_ms"],
            "bound_ms": shard_res["snap_bound_ms"], "bound_by": shard_res["snap_bound_by"], "library_ms": None,
            "device_ms": vqs_res["rank_rows"]["snap_per_predict_ms"], "backend": backend, "world": WORLD,
            "tolerance": {**VQ_TOL, "vs_one_rank_snap": "exact", "collectives": 0},
            "index_mismatches": shard_res["snap_index_mismatches"],
            "shapes": f"per predict per rank of {WORLD}: 2 x n={shard_res['snap_rows'][0]} + 2 x n={shard_res['snap_rows'][1]} rows, "
                      "H=4, d=64, K=64; launches per rank in one predict of the batch of 4",
            # every QS-TTS snap calls this function; on one card with no group
            "launches_qs_tts": {"analysis_synthesis_batch": qs_as["launches"]["vq_nearest"],
                                "predictor_step": qs_pred["launches_per_step"]["vq_nearest"]},
            "qs_tts_shapes": f"one rank: N={QS_B * QS_FRAMES // 4} + {QS_B * QS_FRAMES} per analysis-synthesis batch, "
                             f"N={AM_B * AM_FRAMES // 4} + {AM_B * AM_FRAMES} per predictor step",
            "launches_istft": {"analysis_synthesis_batch": ist_as["launches"]["vq_nearest"],
                               "predict_batch": ist_pr["launches"]["vq_nearest"]},
            "launches_int8": {"analysis_synthesis_batch": int8["decoder"]["launches"]["vq_nearest"],
                              "predict_batch": int8["serving"]["predict"]["launches"]["vq_nearest"]},
            "launches_qat": launches_qat("vq_nearest"),
            "launches_ljspeech": {"analysis_synthesis_batch": lj_as["launches"]["vq_nearest"],
                                  "predict": lj_tools["synthesize_launches"]["vq_nearest"]},
            # phase 11 over the group, per rank of 2: --int8 predict of phase 5's batch and phase 13's
            # streamed batch, every launch held against plain on the rank's inputs; phase 23 (b): the AM
            # teacher's snaps per rank of the tensor-parallel step
            "launches_group": {"int8_predict_batch": dp_infer["int8"]["launches"]["vq_nearest"],
                               "streamed_batch": dp_infer["stream"]["launches"]["vq_nearest"],
                               "engine_served_batches": {k: v if k == "batches" else v["vq_nearest"]
                                                         for k, v in dp_infer["engine"]["launches"].items()},
                               "tensor_parallel_am_step": 2},
            "group": {"int8_predict": dp_infer["int8"]["snaps"], "streamed_batch": dp_infer["stream"]["snaps"]},
        },
        {
            "name": "fused_resblock_layer", "route": "cuda", "source": "msmctts_tpu_torch/csrc/resblock.cu",
            "replaces": "msmctts_tpu/ops/pallas_resblock.py:113",
            "launches": tts_res["launches"]["fused_resblock_layer"],
            "max_abs_err": rb_res["max_abs_err"], "ms": rb_res["ms"], "plain_ms": rb_res["plain_ms"],
            "bound_ms": rb_res["bound_ms"], "bound_by": "operations", "library_ms": rb_res["library_ms"],
            "body": sorted({r["body"] for r in rb_res["rows"]}), "bound_fp32_ms": rb_res["bound_fp32_ms"],
            "per_width": rb_res["per_width"],
            # serving: 36 per window decode, over every window of one streamed batch
            "launches_serving": serving["stream"]["launches"]["fused_resblock_layer"],
            "window_shapes": serving["window"]["shapes"],
            "window": {k: serving["window"][k] for k in ("ms", "plain_ms", "bound_ms", "max_abs_err")},
            # QS-TTS: the x200 generator's 36 layers per analysis-synthesis batch (B=4, 512 frames)
            "launches_qs_tts": qs_as["launches"]["fused_resblock_layer"],
            "qs_tts": {k: qs_as["resblock"][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_fp32_ms",
                                                          "max_abs_err", "shapes")},
            # the ISTFT recipe's trunk: 18 per analysis-synthesis batch (B=4, 512 frames) and per predict;
            # none under the int8 decoder, whose every trunk conv is an int8 product
            "launches_istft": {"analysis_synthesis_batch": ist_as["launches"]["fused_resblock_layer"],
                               "predict_batch": ist_pr["launches"]["fused_resblock_layer"]},
            "istft": {k: ist_as["resblock"][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_fp32_ms",
                                                         "max_abs_err", "shapes", "per_width")},
            "launches_int8": {"analysis_synthesis_batch": int8["decoder"]["launches"]["fused_resblock_layer"],
                              "predict_batch": int8["serving"]["predict"]["launches"]["fused_resblock_layer"]},
            # phase 17: 36 per decode of the QAT precompute, the sweep, debug_step and evaluate; the
            # 36 layers at the precompute's longest utterance (B=1)
            "launches_qat": launches_qat("fused_resblock_layer"),
            "qat": t_qat["resblock"],
            # phase 18: the LJSpeech [8, 8, 2, 2] generator's 36 layers per analysis-synthesis batch (B=4, 512
            # frames: T = 4096 / 32768 / 65536 / 131072 at C = 256 / 128 / 64 / 32) and per predict
            "launches_ljspeech": {"analysis_synthesis_batch": lj_as["launches"]["fused_resblock_layer"],
                                  "predict": lj_tools["synthesize_launches"]["fused_resblock_layer"]},
            "ljspeech": {k: lj_as["resblock"][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_fp32_ms",
                                                           "max_abs_err", "shapes", "per_width")},
            # the daemon's largest warm shape: the 36 layers at B=8, bucket 512
            "launches_ljspeech_daemon_batch": lj_daemon["batch_launches"]["fused_resblock_layer"],
            "ljspeech_daemon": lj_daemon["resblock"],
            # phase 19: a bf16 predict (B=4, bucket 512): its 36 layers read fp32, held against plain on their inputs
            "launches_bf16": bf_inf["launches"]["fused_resblock_layer"],
            "bf16": {"max_abs_err": bf_inf["resblock_max_abs_err"], "shapes": bf_inf["resblock_shapes"]},
            # phase 20: none under bf16 --int8; 36 per analysis-synthesis batch of the options' checkpoint in
            # each learned mode and per batch of the legacy TTS task (autoencoder and vocoder endings),
            # every layer held against plain on its inputs
            "launches_options": {"int8_bf16_analysis_synthesis_batch": o_i8["launches"]["fused_resblock_layer"],
                                 **{f"{m}_analysis_synthesis_batch": o_tr["modes"][m]["launches"]["fused_resblock_layer"]
                                    for m in o_tr["modes"]},
                                 **{f"legacy_tts_{e}_batch": o_tts[e]["launches"]["fused_resblock_layer"]
                                    for e in ("autoencoder", "vocoder")}},
            "options": {"max_abs_err": max([o_tr["modes"][m]["resblock_max_abs_err"] for m in o_tr["modes"]]
                                           + [o_tts[e]["resblock_max_abs_err"] for e in ("autoencoder", "vocoder")])},
            # phase 21: the 36 layers of the fp32 artifact's decode (B=4, 512 frames) through the
            # msmctts::fused_resblock_layer operator; none in the int8 artifact
            "launches_export": {"fp32_artifact_batch": fx_exp["launches"]["fused_resblock_layer"],
                                "int8_artifact_batch": fx_exp["int8"]["launches"]["fused_resblock_layer"]},
            "export": {"max_abs_err": fx_exp["resblock_max_abs_err"]},
            # phase 22: the 36 layers of infer -m <snapshot>'s batch of 4, held against plain on their inputs
            "launches_orbax": {"infer_snapshot_batch": ob_sv["launches"]["fused_resblock_layer"]},
            "orbax": {"max_abs_err": ob_sv["resblock_max_abs_err"]},
            # phase 11: 36 per window per rank of phase 13's streamed batch over the group (2 rows a rank),
            # held against plain at the window's 36 layers of 2 rows; none under --int8
            "launches_group": {"streamed_batch": dp_infer["stream"]["launches"]["fused_resblock_layer"],
                               "int8_predict_batch": dp_infer["int8"]["launches"]["fused_resblock_layer"],
                               "engine_served_batches": {k: v if k == "batches" else v["fused_resblock_layer"]
                                                         for k, v in dp_infer["engine"]["launches"].items()}},
            "group_window": {k: dp_infer["stream"]["window"][k] for k in ("ms", "plain_ms", "bound_ms", "max_abs_err", "shapes")},
            "tolerance": {**RB_TOL, "max_abs": RB_MAX_ABS},
            "shapes": f"per decode: the 36 CSMSC MRF layers at B={B}, {FRAMES} frames; bound_ms counts the kernel's operations, "
                      "three TF32 tensor-core products per fp32 product at 495 TFLOP/s; bound_fp32_ms the same products as "
                      "fp32 FMA at 67 TFLOP/s, which the library call is bound by",
        },
    ]
    vq_bound_by = {r["bound"][1] for r in vq_res["rows"] if "bound" in r}
    kernels[0]["bound_by"] = "bytes" if vq_bound_by == {"bytes"} else "operations"
    print(env["nvidia_smi"], flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"env": env, "build": build, "vq": vq_res, "vq_stats": vqs_res, "resblock": rb_res,
                       "analysis_synthesis": as_res, "text_to_wav": tts_res, "profile": profile,
                       "training": train_res, "step_card_vs_cpu": step_res,
                       "sharded_kernels": shard_res, "nccl_world_1": nccl_res, "dp_training": dp_train,
                       "dp_inference": dp_infer, "am_training": am_res, "am_step_card_vs_cpu": am_cpu,
                       "am_entry_point": am_cli, "serving": serving, "qs_tts": qs, "istft": istft, "int8": int8,
                       "quality_tools": tools, "ljspeech": lj, "bf16": bf16, "options": opts, "feed_export": fx, "orbax": ob,
                       "group": grp, "train_graphs": graphs_res, "phase_s": spent, "wall_s": time.perf_counter() - t_start}, f, indent=1)
    log(f"[end] seconds per phase {json.dumps(spent)}")
    log(f"[end] wall {time.perf_counter() - t_start:.1f}s on {env['nvidia_smi']}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": env["name"], "count": env["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
