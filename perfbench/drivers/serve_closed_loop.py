"""Closed-loop serving of a TTS model through the program's batching engine.

Set-up builds the program's task from the configuration, loads the seeded
weights (``perfbench/weights.py``), starts ``serving.BatchingEngine`` with
its warmup of the cell's shapes on the engine's worker thread, and sends
one priming request. The window then runs ``clients`` threads, each sending
its next blocking ``synthesize`` when the last one returned, texts from
``perfbench/traffic.py``; a client sends nothing after the window closes,
and the requests in flight then are waited for.

The benchmark wraps the task's ``infer_step`` on the engine instance (the
program's own files are not touched): its host span, the durations served
to every request, and for the watched requests (every ``check.every``-th of
the window's stream from an offset drawn from the seed, and every one of the
longest text) the frame totals and each stage's codewords (from a forward
hook on the predictor) beside the waveforms the clients got. After the
window the plain reference (``perfbench/reference/judge_tts.py``) judges a
sample drawn from the seed: ``check.requests`` of the watched requests sent
in the window and the longest of them, and the durations of ``check.pool``
of all requests sent. With ``--trace 1`` the wrapper also starts the
profiler on the worker thread at the priming request and stops it at the
first task call after the window's first ``trace_seconds`` (at a closing
request after a shorter window); ``trace.Ranges`` marks the layers' calls
with ``record_function`` ranges meanwhile.
"""

from __future__ import annotations

import gc
import itertools
import random
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import traffic, weights
from perfbench.core import percentile, untraced_rest
from perfbench.trace import Ranges, Tracer

IDLE_LABEL = "engine"  # the worker outside the task call: gather, padding, slicing
NEVER_S = 1e9  # the latency of a failed request: it misses any limit


def _key(text: np.ndarray) -> int:
    """A request's text as a dict key (every request's text is distinct)."""
    return hash(np.ascontiguousarray(text).tobytes())


def build(cell):
    """The program's task over the seeded weights, and the weight spec."""
    from msmctts_tpu_torch.config import Config
    from msmctts_tpu_torch.tasks import build_task

    task = build_task(Config(cell.config["program"]), device=cell.device)
    spec = weights.spec_of(task.networks)
    weights.load(task.networks, weights.make(spec, cell.config["weight_seed"], cell.device,
                                             cell.config.get("overrides")))
    return task, spec


def run(cell) -> dict:
    from msmctts_tpu_torch.serving import BatchingEngine

    mix, cfg = cell.mix, cell.config
    eng_cfg = mix["engine"]
    task, spec = build(cell)
    task_cfg = cfg["program"]["task"]
    tr = dict(mix, n_symbols=task_cfg["predictor"]["n_symbols"])
    engine = BatchingEngine(task, cfg["program"]["dataset"]["samplerate"], batch_size=eng_cfg["batch_size"],
                            window_ms=eng_cfg["window_ms"], text_length=eng_cfg["text_length"],
                            max_frames=eng_cfg["max_frames"])
    engine.start(warmup={"text_lengths": [eng_cfg["text_length"]], "include_streaming": False})

    # every text of the run, drawn before the window
    check = mix["check"]
    texts = traffic.texts(cell.seed, tr, int(cell.seconds * mix["max_rate"]))
    ids = {_key(t): i for i, t in enumerate(texts)}
    rng = random.Random(cell.seed ^ 0x5EED)
    offset = rng.randrange(check["every"])
    watched = {i for i, t in enumerate(texts) if i % check["every"] == offset or len(t) == mix["max_phones"]}
    priming = traffic.texts(cell.seed + 1, tr, 1)[0]  # not a request of the window
    sent = itertools.count()

    served: Dict[int, dict] = {}  # the watched requests' outputs
    durs: Dict[int, np.ndarray] = {}  # the durations served to every request
    spans: List[tuple] = []  # (start, end, batch rows, frame bucket) of every task call
    ranges = Ranges()
    tracer = Tracer(cell.device.type == "cuda") if cell.trace else None
    state = {"rows": [], "start_trace": False, "stop_trace": False, "trace_until": None, "trace_end": None,
             "trace_resume": None}

    predictor = task.networks["predictor"]

    def capture(module, args, kwargs, out):
        state["frames"] = int(out["feat"][-1].shape[1])
        for row, rid in state["rows"]:
            served[rid]["feat"] = [f[row].detach().clone() for f in out["feat"]]

    predictor.register_forward_hook(capture, with_kwargs=True)
    infer = task.infer_step

    def infer_step(batch):
        if state["start_trace"]:
            state["start_trace"] = False
            tracer.start()
            ranges.active = True
        until = state["trace_until"]
        if state["stop_trace"] or (until is not None and time.perf_counter() >= until):
            state["stop_trace"], state["trace_until"] = False, None
            state["trace_end"] = time.perf_counter()
            ranges.active = False
            tracer.stop()
            state["trace_resume"] = time.perf_counter()
        rows, seen = [], []
        for i, (t, n) in enumerate(zip(batch["text"], batch["text_length"])):
            rid = ids.get(_key(t[: int(n)]))
            if rid is None or rid in durs:
                continue
            durs[rid] = None
            seen.append((i, rid))
            if rid in watched:
                served[rid] = {}
                rows.append((i, rid))
        state["rows"] = rows
        t0 = time.perf_counter()
        ranges.enter("task_call", (len(batch["text"]),))
        try:
            out = infer(batch)
        finally:
            ranges.exit()
        spans.append((t0, time.perf_counter(), len(batch["text"]), state.get("frames")))
        for row, rid in seen:
            durs[rid] = np.array(out["duration"][row])
        for row, rid in rows:
            served[rid].update(dur=durs[rid], total=int(out["mel_length"][row]))
        return out

    task.infer_step = infer_step
    if tracer is not None:
        from msmctts_tpu_torch.models import predictor as predictor_py

        tracer.prime()
        ae = task.networks["autoencoder"]
        ranges.around(predictor_py, "snap_with_codebook", "snap")
        for codebook in ae.quantizer.quantizer:
            ranges.around(codebook, "quantize", "snap")  # the re-quantization in synthesis
        ranges.around(predictor, "predict_durations", "durations")
        ranges.module(predictor, "predictor")
        ranges.around(ae, "synthesis_features", "synthesis")
        ranges.around(task, "_gather", "host_copy")
        dec = task_cfg["autoencoder"]["decoder_config"]
        nk = len(dec["resblock_kernel_sizes"])
        for j, block in enumerate(ae.decoder.resblocks):
            C = dec["upsample_initial_channel"] // 2 ** (j // nk + 1)
            k = dec["resblock_kernel_sizes"][j % nk]
            n_dil = len(dec["resblock_dilation_sizes"][j % nk])
            ranges.module(block, "resblock", lambda x, C=C, k=k, n=n_dil: (x.shape[0], x.numel() // (x.shape[0] * C),
                                                                          C, k, n))
        ranges.module(ae.decoder, "decoder")
        state["start_trace"] = True
    n_clients = mix["clients"]
    engine.synthesize(priming)  # the worker starts the tracer here

    lock = threading.Lock()
    results: List[tuple] = []  # (rid, n_phones, sent, done or None, samples)
    start_at = time.perf_counter()
    setup_s = start_at - cell.t_start
    end_at = start_at + cell.seconds
    if tracer is not None:  # the trace covers the window's first trace_seconds
        state["trace_until"] = start_at + mix["trace_seconds"]

    def client():
        while True:
            with lock:
                if time.perf_counter() >= end_at:
                    return
                rid = next(sent)
            text = texts[rid % len(texts)]
            t_sent = time.perf_counter()
            try:
                wav = engine.synthesize(text, timeout=mix["request_timeout_s"])
                done = time.perf_counter()
            except Exception as e:  # a failed request: missing, whatever its latency
                results.append((rid, len(text), t_sent, None, 0))
                cell.log(f"request {rid} failed: {type(e).__name__}: {e}")
                continue
            results.append((rid, len(text), t_sent, done, len(wav)))
            if rid in watched:
                served.setdefault(rid, {})["wav"] = wav

    threads = [threading.Thread(target=client, daemon=True) for _ in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if tracer is not None and state["trace_end"] is None:
        state["stop_trace"] = True
        engine.synthesize(priming)
    if cell.device.type == "cuda":
        torch.cuda.synchronize()
    memory_peak = torch.cuda.max_memory_allocated() if cell.device.type == "cuda" else 0
    counters = {"cold_shapes": engine.cold_shapes(), "kernel_builds": engine.kernel_builds()}
    engine.stop()
    ranges.close()

    ratio = int(np.prod(task_cfg["autoencoder"]["decoder_config"]["upsample_rates"]))
    rate = cfg["program"]["dataset"]["samplerate"]
    in_window = [r for r in results if r[2] < end_at]
    completed = [r for r in in_window if r[3] is not None and r[3] <= end_at]
    failed = sum(r[3] is None for r in in_window)
    lat = [(r[3] - r[2]) if r[3] is not None else NEVER_S for r in in_window] or [NEVER_S]
    e2e = {
        "audio_s_per_s": sum(r[4] for r in completed) / rate / cell.seconds,
        "latency_p95_ms": percentile(lat, 95) * 1e3,
        "setup_s": setup_s,
    }

    record = {
        "task": task_cfg, "spans": spans, "calls": ranges.calls,
        "window": (start_at, min(end_at, state["trace_end"] or end_at)),
        "untraced": untraced_rest(state["trace_resume"], end_at),
        "completed": [(r[1], r[4] // ratio, r[3]) for r in completed],
        "trace": tracer.trace if tracer is not None else None, "idle_label": IDLE_LABEL, "call_range": "task_call",
    }
    del engine, task, predictor, infer
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()

    from perfbench.reference.judge_tts import judge

    # the sample, from the requests sent in the window: the watched ones
    # with the longest of them, and the durations of a pool of all of them
    sent_ids = sorted(r[0] for r in in_window)
    seen_watched = [rid for rid in sent_ids if rid in watched]
    sample = set(rng.sample(seen_watched, min(check["requests"], len(seen_watched))))
    if seen_watched:
        sample.add(max(seen_watched, key=lambda rid: (len(texts[rid]), -rid)))
    judged = set(rng.sample(sent_ids, min(check["pool"], len(sent_ids)))) | sample
    sampled = {rid: served.get(rid, {}) for rid in sample}
    del served
    W = weights.make(spec, cfg["weight_seed"], cell.device, cfg.get("overrides"))
    judged_texts = {rid: texts[rid % len(texts)] for rid in judged}
    judged_durs = {rid: durs.get(rid) for rid in judged}
    readings = judge(W, task_cfg, eng_cfg, judged_texts, sampled, judged_durs)
    readings.update(failed=failed, **counters)
    checks = {k: (v, cell.workload["limits"][k]) for k, v in readings.items()}
    return {"e2e": e2e, "record": record, "checks": checks, "attempted": len(in_window), "failed": failed,
            "memory_peak_bytes": memory_peak,
            "judged": {"W": W, "texts": judged_texts, "served": sampled, "durs": judged_durs}}

