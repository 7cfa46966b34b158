#!/usr/bin/env python3
"""Drive the PyTorch port (msmctts_tpu_torch) on one GPU and check it.

    python3 chip_smoke.py [--out results.json]

Phases, each of which raises on failure:
  1. environment: the card's name and power limit; TF32 off;
  2. build both CUDA kernels from msmctts_tpu_torch/csrc (one nvcc each,
     in parallel);
  3. each kernel against its plain PyTorch version on the card at the
     shapes the main path gives it (CSMSC, batch 4, frame bucket 512),
     with kernel, plain and library-call times (CUDA events, median of
     repeated runs after warm-up) and the least time the card could take;
  4. the autoencoder's analysis-synthesis on the committed trained CSMSC
     weights, checked against the same model on the CPU on a small input,
     and the kernels' launch counts on a batch of 256 and 448 frames;
  5. text -> wav at the full width of the CSMSC recipe (seeded acoustic
     model, trained autoencoder): the ``synthesize`` entry point once as a
     subprocess, a small request against the CPU, then ``predict`` on a
     batch of 4 requests with launch counts and per-batch times;
  6. one JSON line describing each kernel;
  7. last line: {"ok": true, "device": {...}}.

It exits non-zero, printing no result, without a CUDA device or without
the rest of the repository. ``--out`` also profiles one warm ``predict``
(device time by kernel, busy share) and writes every measurement to a JSON
file.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "csmsc_ae_r5.f16.ckpt")
AM_YAML = os.path.join(ROOT, "examples", "csmsc", "configs", "msmc_vq_gan_am.yaml")
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
RB_TOL = {"rtol": 2e-4, "atol": 2e-4}
AS_TOL = 5e-4  # wav, card vs CPU, as the CPU parity tests hold the port to JAX


def log(*args):
    print(*args, flush=True)


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
    info = cuda_build.build(["vq_nearest", "resblock"])
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


def phase_vq(gen):
    from msmctts_tpu_torch.ops import vq

    rows, worst_err, flips = [], 0.0, 0
    for label, N, tie in (("stage0", B * FRAMES // 4, False), ("stage1", B * FRAMES, False),
                          ("ragged", 2047, False), ("tie", 640, True)):
        x, e = _vq_case(gen, N, tie)
        idx, quant = vq.vq_nearest(x, e)
        ref_idx, ref_quant = vq.vq_nearest_plain(x, e)
        torch.cuda.synchronize()
        same = idx == ref_idx
        if not bool(same.all()):
            x64, e64 = x.double(), e.double()
            dist = (x64 * x64).sum(-1, keepdim=True) - 2 * torch.einsum("nhd,hdk->nhk", x64, e64) + (e64 * e64).sum(1)
            d_k = dist.gather(-1, idx.long()[..., None])[..., 0]
            d_p = dist.gather(-1, ref_idx.long()[..., None])[..., 0]
            rel = ((d_k - d_p).abs() / d_p.abs().clamp_min(1.0))[~same]
            if float(rel.max()) > VQ_TOL["index_tie_rel_gap"]:
                raise AssertionError(f"vq {label}: index mismatch with distance gap {float(rel.max()):.3g}")
            flips += int((~same).sum())
        err = float((quant - ref_quant)[same].abs().max()) if bool(same.any()) else 0.0
        if err > VQ_TOL["quant_atol"]:
            raise AssertionError(f"vq {label}: codeword rows differ by {err}")
        if tie and not bool((idx[::2] == 4).all()):
            raise AssertionError("vq tie: the first of two equal codewords must win")
        worst_err = max(worst_err, err)
        row = {"label": label, "N": N, "mismatches": int((~same).sum()), "max_abs_err": err}
        if label.startswith("stage"):
            nbytes = (N * VQ_H * VQ_D * 2 + VQ_H * VQ_D * VQ_K + N * VQ_H) * 4
            flops = 2 * N * VQ_H * VQ_D * VQ_K + 3 * N * VQ_H * VQ_K
            row.update(
                ms=time_ms(lambda: vq.vq_nearest(x, e), runs=50),
                plain_ms=time_ms(lambda: vq.vq_nearest_plain(x, e), runs=50),
                bound=bound(nbytes, flops),
                library_ms=None,  # no single PyTorch call computes argmin + gather per head
            )
        rows.append(row)
        log(f"[3] vq_nearest {label} N={N}: {json.dumps(row)}")
    # a predict launches it twice per stage: the predictor snap and the re-quant
    per_predict = {
        key: 2 * sum(r[key] for r in rows if r["label"].startswith("stage")) for key in ("ms", "plain_ms")
    }
    per_predict["bound_ms"] = 2 * sum(r["bound"][0] for r in rows if r["label"].startswith("stage"))
    return {"rows": rows, "max_abs_err": worst_err, "tie_flips": flips, **per_predict}


def phase_resblock(gen):
    import torch.nn.functional as F

    from msmctts_tpu_torch.ops import resblock as rb

    rows, worst = [], 0.0
    T = FRAMES
    for C, up in STAGES:
        T *= up
        x = torch.randn(B, T, C, device="cuda", generator=gen)
        x_ncl = x.transpose(1, 2).contiguous()
        for k in RB_KERNELS:
            s = (k * C) ** -0.5
            w1 = torch.randn(k, C, C, device="cuda", generator=gen) * s
            w2 = torch.randn(k, C, C, device="cuda", generator=gen) * s
            b1 = torch.randn(C, device="cuda", generator=gen) * 0.1
            b2 = torch.randn(C, device="cuda", generator=gen) * 0.1
            w1t, w2t = w1.permute(2, 1, 0).contiguous(), w2.permute(2, 1, 0).contiguous()
            for d in RB_DILATIONS:
                y = rb.fused_resblock_layer(x, w1, b1, w2, b2, d)
                ref = rb.fused_resblock_layer_plain(x, w1, b1, w2, b2, d)
                torch.cuda.synchronize()
                err = float((y - ref).abs().max())
                if not torch.allclose(y, ref, **RB_TOL):
                    raise AssertionError(f"resblock C={C} k={k} d={d}: max abs err {err}")
                worst = max(worst, err)

                def library():
                    h = F.conv1d(F.leaky_relu(x_ncl, 0.1), w1t, b1, padding=(k - 1) // 2 * d, dilation=d)
                    return x_ncl + F.conv1d(F.leaky_relu(h, 0.1), w2t, b2, padding=(k - 1) // 2)

                flops = 4 * k * C * C * B * T
                nbytes = (2 * B * T * C + 2 * (k * C * C + C)) * 4
                row = {
                    "C": C, "T": T, "k": k, "d": d, "tile": rb.choose_tile(C, k, d), "max_abs_err": err,
                    "ms": time_ms(lambda: rb.fused_resblock_layer(x, w1, b1, w2, b2, d)),
                    "plain_ms": time_ms(lambda: rb.fused_resblock_layer_plain(x, w1, b1, w2, b2, d)),
                    "library_ms": time_ms(library),
                    "bound": bound(nbytes, flops),
                    "bound_tf32_ms": bound(nbytes, flops, PEAK_TF32)[0],
                    "bound_bf16_ms": bound(nbytes // 2, flops, PEAK_BF16)[0],
                }
                row["tflops"] = flops / row["ms"] / 1e9
                rows.append(row)
                log(f"[3] resblock {json.dumps(row)}")
    total = {key: sum(r[key] for r in rows) for key in ("ms", "plain_ms", "library_ms", "bound_tf32_ms", "bound_bf16_ms")}
    total["bound_ms"] = sum(r["bound"][0] for r in rows)
    log(f"[3] resblock, all 36 layers of one decode (B={B}, {FRAMES} frames): {json.dumps(total)}")
    return {"rows": rows, "max_abs_err": worst, **total}


def _reset_counts():
    from msmctts_tpu_torch.ops import resblock, vq

    vq.KERNEL.launches = 0
    resblock.KERNEL.launches = 0


def _counts():
    from msmctts_tpu_torch.ops import resblock, vq

    return {"vq_nearest": vq.KERNEL.launches, "fused_resblock_layer": resblock.KERNEL.launches}


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
    if counts != {"vq_nearest": 2, "fused_resblock_layer": 36}:
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
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "msmctts_tpu_torch.synthesize", "-m", am_path, "--text", tokens, "-o", wav_path],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    if res.returncode != 0 or not os.path.exists(wav_path):
        raise AssertionError(f"synthesize failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    log(f"[5] synthesize subprocess ({time.perf_counter() - t0:.1f}s): {res.stdout.strip().splitlines()[-1]}")

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
    if counts != {"vq_nearest": 4, "fused_resblock_layer": 36}:
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
    return result, lambda: task.predict(batch)


def profile_predict(predict):
    """Device time by kernel name over one warm ``predict``, and the card's
    busy share of its wall time (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predict()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:  # host ops also carry their kernels' time
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0 and ev.count > 0:
            rows.append({"name": ev.key[:120], "count": ev.count, "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    busy_ms = sum(r["device_ms"] for r in rows)
    log(f"[5] profiled predict: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({busy_ms / wall_ms:.0%}), {sum(r['count'] for r in rows)} kernels")
    for r in rows[:12]:
        log(f"[5]   {r['device_ms']:8.3f} ms  x{r['count']:<4d} {r['name']}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "kernels": rows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also profile one predict and write every measurement to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import msmctts_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    t_start = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    env = phase_environment()
    build = phase_build()
    vq_res = phase_vq(gen)
    rb_res = phase_resblock(gen)
    as_res = phase_analysis_synthesis()
    tts_res, predict = phase_text_to_wav(env["nvidia_smi"])
    profile = profile_predict(predict) if args.out else None

    kernels = [
        {
            "name": "vq_nearest", "route": "cuda", "source": "msmctts_tpu_torch/csrc/vq_nearest.cu",
            "replaces": "msmctts_tpu/ops/pallas_vq.py:160", "launches": tts_res["launches"]["vq_nearest"],
            "max_abs_err": vq_res["max_abs_err"], "ms": vq_res["ms"], "plain_ms": vq_res["plain_ms"],
            "bound_ms": vq_res["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "tolerance": VQ_TOL, "shapes": "per predict: 2 x N=512 + 2 x N=2048, H=4, d=64, K=64",
        },
        {
            "name": "fused_resblock_layer", "route": "cuda", "source": "msmctts_tpu_torch/csrc/resblock.cu",
            "replaces": "msmctts_tpu/ops/pallas_resblock.py:113",
            "launches": tts_res["launches"]["fused_resblock_layer"],
            "max_abs_err": rb_res["max_abs_err"], "ms": rb_res["ms"], "plain_ms": rb_res["plain_ms"],
            "bound_ms": rb_res["bound_ms"], "bound_by": "operations", "library_ms": rb_res["library_ms"],
            "tolerance": RB_TOL, "shapes": f"per decode: the 36 CSMSC MRF layers at B={B}, {FRAMES} frames",
        },
    ]
    vq_bound_by = {r["bound"][1] for r in vq_res["rows"] if "bound" in r}
    kernels[0]["bound_by"] = "bytes" if vq_bound_by == {"bytes"} else "operations"
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"env": env, "build": build, "vq": vq_res, "resblock": rb_res,
                       "analysis_synthesis": as_res, "text_to_wav": tts_res, "profile": profile,
                       "wall_s": time.perf_counter() - t_start}, f, indent=1)
    log(f"[6] wall {time.perf_counter() - t_start:.1f}s on {env['nvidia_smi']}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": env["name"], "count": env["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
