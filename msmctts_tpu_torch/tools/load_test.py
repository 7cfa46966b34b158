"""Load-test a live serving daemon of the port and record serving
performance (counterpart of the root ``tools/load_test.py``).

Drives the HTTP front end (``python -m msmctts_tpu_torch.serve``) with
blocking and streaming synthesis requests at several closed-loop
concurrency levels and records, per level:

  * client-side requests/s and latency percentiles (p50/p95/p99),
  * streaming time-to-first-audio (first PCM chunk past the RIFF header),
  * the server's own counters diffed across the window (/stats): batches,
    mean batch size, device real-time factor, errors, and the port's
    ``cold_shapes`` and ``kernel_builds`` (the JAX daemon's
    ``xla_compiles``).

Against an already-running server:

    python -m msmctts_tpu_torch.tools.load_test --url http://127.0.0.1:8080 \\
        --levels 1 4 16 --requests 48 --out serving_load.json

Or spawn the server too (everything after ``--`` goes to
``python -m msmctts_tpu_torch.serve``; its ``--port`` names the URL):

    python -m msmctts_tpu_torch.tools.load_test --spawn --levels 1 4 16 \\
        --out serving_load.json -- -m <am_checkpoint> --port 8093 --batch-size 8

Texts are random ``id_tone_er`` token strings drawn from the model's
vocabulary (``--n-symbols``, CSMSC's [100, 10, 2] by default; LJSpeech's is
[256]) with token counts uniform in [--min-tokens, --max-tokens]: every
request is distinct. The report's ``cold_shapes_during_run`` and
``kernel_builds_during_run`` count what the daemon compiled or first ran
while load was applied (after one priming request); 0 is the warmup's
guarantee.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import random
import statistics
import subprocess
import sys
import threading
import time
import urllib.parse
import urllib.request

# the counters of /stats that warmup guarantees to stay at 0 under load
WARM_COUNTERS = ("cold_shapes", "kernel_builds")


def rand_text(rng: random.Random, n_symbols, lo: int, hi: int) -> str:
    n = rng.randint(lo, hi)
    return " ".join("_".join(str(rng.randrange(1, max(s, 2))) for s in n_symbols) for _ in range(n))


def get_json(url: str, timeout: float = 10.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def post_synthesize(base: str, text: str, timeout: float) -> dict:
    """Blocking request; returns {latency_s, duration_s} (JSON format, so the
    audio seconds come back without decoding a WAV)."""
    body = json.dumps({"text": text, "format": "json"}).encode()
    req = urllib.request.Request(base + "/synthesize", data=body, headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        payload = json.loads(r.read())
    return {"latency_s": time.perf_counter() - t0, "duration_s": float(payload["duration_s"])}


def stream_ttfa(base: str, text: str, timeout: float) -> dict:
    """Streaming request; wall time to the first PCM bytes past the 44-byte
    RIFF header and to the last chunk."""
    u = urllib.parse.urlparse(base)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=timeout)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/synthesize", body=json.dumps({"text": text, "stream": True}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            raise RuntimeError(f"HTTP {resp.status}: {resp.read()[:200]!r}")
        total, ttfa = 0, None
        while True:
            piece = resp.read(8192)  # http.client de-chunks
            if not piece:
                break
            total += len(piece)
            if ttfa is None and total > 44:  # audio past the RIFF header
                ttfa = time.perf_counter() - t0
        return {"ttfa_s": ttfa, "total_s": time.perf_counter() - t0, "audio_s": max(total - 44, 0) / 2.0}
    finally:
        conn.close()


def percentiles(xs):
    if not xs:
        return {"p50": None, "p95": None, "p99": None}
    xs = sorted(xs)
    pick = lambda p: xs[min(len(xs) - 1, int(p * len(xs)))]
    return {"p50": pick(0.50), "p95": pick(0.95), "p99": pick(0.99)}


def diff_stats(before: dict, after: dict) -> dict:
    d = {k: after[k] - before[k] for k in ("requests", "batches", "errors") + WARM_COUNTERS}
    d["mean_batch_size"] = (d["requests"] / d["batches"]) if d["batches"] else None
    d["audio_seconds"] = round(after["audio_seconds"] - before["audio_seconds"], 3)
    # cumulative, not windowed: the run-wide figures
    d["device_realtime_factor"] = after.get("device_realtime_factor")
    d["server_latency_s"] = after.get("latency_s")
    return d


def run_level(base, level, n_requests, rng, args):
    """Closed loop: ``level`` workers issue requests back to back until
    ``n_requests`` have completed."""
    lock = threading.Lock()
    results, errors = [], []
    issued = [0]

    def worker():
        while True:
            with lock:
                if issued[0] >= n_requests:
                    return
                issued[0] += 1
                text = rand_text(rng, args.n_symbols, args.min_tokens, args.max_tokens)
            try:
                r = post_synthesize(base, text, args.timeout)
                with lock:
                    results.append(r)
            except Exception as e:  # noqa: BLE001 (recorded; the load goes on)
                with lock:
                    errors.append(f"{type(e).__name__}: {e}")

    before = get_json(base + "/stats")
    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker) for _ in range(level)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    after = get_json(base + "/stats")

    lats = [r["latency_s"] for r in results]
    audio = sum(r["duration_s"] for r in results)
    out = {
        "concurrency": level,
        "requests": len(results),
        "client_errors": len(errors),
        "wall_s": round(wall, 3),
        "requests_per_s": round(len(results) / wall, 3) if wall else None,
        "audio_seconds": round(audio, 2),
        "served_realtime_factor": round(audio / wall, 1) if wall else None,
        "latency_s": {k: round(v, 4) if v is not None else None for k, v in percentiles(lats).items()},
        "server_window": diff_stats(before, after),
    }
    if errors:
        out["error_samples"] = errors[:5]
    return out


def run_streaming(base, n_requests, rng, args):
    """Sequential streaming requests: time to first audio, one at a time."""
    rows = [stream_ttfa(base, rand_text(rng, args.n_symbols, args.min_tokens, args.max_tokens), args.timeout)
            for _ in range(n_requests)]
    ttfas = [r["ttfa_s"] for r in rows if r["ttfa_s"] is not None]
    totals = [r["total_s"] for r in rows]
    return {
        "requests": len(rows),
        "ttfa_s": {k: round(v, 4) if v is not None else None for k, v in percentiles(ttfas).items()},
        "ttfa_mean_s": round(statistics.mean(ttfas), 4) if ttfas else None,
        "total_s_mean": round(statistics.mean(totals), 4) if totals else None,
        "audio_s_mean": round(statistics.mean(r["audio_s"] for r in rows) / args.sample_rate, 3) if rows else None,
    }


def wait_healthy(base: str, timeout: float, proc=None) -> None:
    t0 = time.time()
    while time.time() - t0 < timeout:
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(f"the spawned server exited with {proc.returncode}")
        try:
            if get_json(base + "/healthz", timeout=5.0).get("status") == "ok":
                return
        except OSError:  # not listening yet, or 503 while it warms up
            pass
        time.sleep(2.0)
    raise TimeoutError(f"server at {base} not healthy after {timeout:.0f}s")


def spawn_command(server_args) -> list:
    """The command ``--spawn`` runs: the port's daemon as a module."""
    return [sys.executable, "-m", "msmctts_tpu_torch.serve"] + list(server_args)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--url", default="http://127.0.0.1:8080")
    p.add_argument("--spawn", action="store_true",
                   help="launch python -m msmctts_tpu_torch.serve (args after --) and wait for health")
    p.add_argument("--levels", type=int, nargs="+", default=[1, 4, 16])
    p.add_argument("--requests", type=int, default=48, help="completed requests per concurrency level")
    p.add_argument("--streaming-requests", type=int, default=8,
                   help="sequential streaming time-to-first-audio probes (0 disables)")
    p.add_argument("--n-symbols", type=int, nargs="+", default=[100, 10, 2])
    p.add_argument("--min-tokens", type=int, default=24)
    p.add_argument("--max-tokens", type=int, default=96)
    p.add_argument("--timeout", type=float, default=180.0)
    p.add_argument("--warmup-timeout", type=float, default=1800.0)
    p.add_argument("--sample-rate", type=int, default=24000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="write the JSON report here")
    p.add_argument("server_args", nargs="*", help="after --: forwarded to the daemon with --spawn")
    args = p.parse_args(argv)

    proc = None
    base = args.url.rstrip("/")
    if args.spawn:
        cmd = spawn_command(args.server_args)
        for i, a in enumerate(args.server_args):
            if a == "--port":
                base = f"http://127.0.0.1:{args.server_args[i + 1]}"
        # the package's root on the path, wherever the tool is run from
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
        print(f"[load_test] spawning: {' '.join(cmd)}", file=sys.stderr)
        proc = subprocess.Popen(cmd, env=env)
    try:
        wait_healthy(base, args.warmup_timeout, proc)
        rng = random.Random(args.seed)
        report = {"base": base, "levels": []}
        # one throwaway request primes any cold path without polluting level 1
        post_synthesize(base, rand_text(rng, args.n_symbols, args.min_tokens, args.max_tokens), args.timeout)
        stats0 = get_json(base + "/stats")
        for level in args.levels:
            row = run_level(base, level, args.requests, rng, args)
            print(json.dumps(row), flush=True)
            report["levels"].append(row)
        if args.streaming_requests:
            report["streaming"] = run_streaming(base, args.streaming_requests, rng, args)
            print(json.dumps({"streaming": report["streaming"]}), flush=True)
        report["final_stats"] = get_json(base + "/stats")
        during = {f"{k}_during_run": report["final_stats"][k] - stats0[k] for k in WARM_COUNTERS}
        report.update(during)
        print(json.dumps(during), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(report, f, indent=2)
            print(f"[load_test] wrote {args.out}", file=sys.stderr)
        return report
    finally:
        if proc is not None:
            proc.terminate()
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=20)


if __name__ == "__main__":
    main()
