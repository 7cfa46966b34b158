"""TTS serving daemon: HTTP front end over the dynamic-batching engine (the
counterpart of the root ``serve.py``).

    python -m msmctts_tpu_torch.serve -m <am_checkpoint> [--port 8080 \\
        --batch-size 8 --window-ms 15 --max-frames 1024 --int8 --device cpu]
    python -m msmctts_tpu_torch.serve --artifact <dir> [--port 8080 --device cpu]

Endpoints
---------
POST /synthesize   body {"text": "3_1_0 5_2_0 ..."} (id_tone[_er] phone
                   tokens). Returns audio/wav; with "format": "json" returns
                   {"wav_b64", "sample_rate", "duration_s", "latency_s"};
                   with "stream": true a chunked-transfer streaming WAV (a
                   RIFF header of unknown length, then int16 PCM pieces as
                   the vocoder emits them).
POST /reload       body {"model": <checkpoint>}: swap the weights between
                   batches.
GET  /healthz      {"status": "ok"} once warmup has finished, 503 before.
GET  /stats        batching counters, latency percentiles, device real-time
                   factor, ``cold_shapes`` and ``kernel_builds``.

The engine pins one batch size, one padded text length (256 phones) and a
per-utterance frame cap (``--max-frames``) and runs every reachable shape at startup,
streaming windows included unless ``--no-warmup-streaming``
(``serving.py``). ``--int8`` serves the int8 HiFi-GAN decoder
(``ops/int8_generator.py``), calibrated on the first batch warmup decodes.
``--artifact DIR`` serves the programs ``tools/export_tts.py`` wrote
(``export.ExportedTTS``) with no model code, config or checkpoint: batch
size, text buckets, frame count and decoder are the export's, streaming and
``/reload`` are refused. It runs on ``cuda`` unless ``--device cpu`` is given;
without a GPU it refuses to run. It prints ``serving on http://host:port``
with the bound port once ready, so ``--port 0`` works.

``--mesh-devices N`` serves one model data-parallel from N ranks (the JAX
package's mesh, ``serve.py:76-79``; N = 0 or -1: every local card), started
through ``parallel/launch.run_ranks``, one process a rank: rank 0 serves
HTTP and holds the engine's queue, the others follow it
(``serving.BatchingEngine(group=...)``); ``--batch-size`` must divide by N.
``--devices`` (CUDA indices, one per rank) and ``--backend`` are the
launch options of ``train_dist``: ``--devices 0,0 --backend gloo`` runs two
ranks on one card, ``--device cpu`` N ranks on the CPU. A follower's
failure fails its batch within ``GROUP_TIMEOUT_S`` seconds.
"""

from __future__ import annotations

import argparse
import base64
import json
import signal
import struct
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from msmctts_tpu_torch.config import Config
from msmctts_tpu_torch.ops.cuda_build import build_count
from msmctts_tpu_torch.parallel import mesh
from msmctts_tpu_torch.parallel.launch import rank_devices, run_ranks
from msmctts_tpu_torch.serving import BatchingEngine
from msmctts_tpu_torch.tasks import build_task
from msmctts_tpu_torch.utils.checkpoint import load_checkpoint

# --mesh-devices: seconds before a collective that a rank never joins fails
GROUP_TIMEOUT_S = 600.0


def build_engine(args, group=None) -> BatchingEngine:
    if args.artifact:
        from msmctts_tpu_torch.export import ExportedTTS

        art = ExportedTTS(args.artifact, device=args.device)
        return BatchingEngine(
            art,
            sample_rate=args.sample_rate or art.sample_rate,
            batch_size=art.batch_size,
            window_ms=args.window_ms,
            text_buckets=art.buckets,
            max_queue=args.max_queue,
        )
    ckpt = load_checkpoint(args.model)
    config = Config(args.config) if args.config else Config(ckpt["config"])
    task = build_task(config, device=args.device)
    task.load_variables(ckpt["state"])
    if args.int8:
        task.int8_decoder = True
    if args.static_frames:
        task.static_max_frames = args.static_frames
    sr = args.sample_rate or int(config.dataset["samplerate"])
    return BatchingEngine(
        task,
        sample_rate=sr,
        batch_size=args.batch_size,
        window_ms=args.window_ms,
        max_frames=args.max_frames,
        max_queue=args.max_queue,
        stream_chunk_frames=args.stream_chunk_frames,
        group=group,
    )


UNKNOWN_SIZE = 0xFFFFFFFF


def _wav_header(sr: int, data_bytes: int = UNKNOWN_SIZE) -> bytes:
    """The 44-byte RIFF/WAVE header of mono 16-bit PCM. It is written here
    rather than by scipy: importing ``scipy.io`` on a server's first
    response holds the interpreter lock for a good part of a second, and
    the worker thread waits for it."""
    riff = UNKNOWN_SIZE if data_bytes == UNKNOWN_SIZE else 36 + data_bytes
    return b"".join([
        b"RIFF", struct.pack("<I", riff), b"WAVE",
        b"fmt ", struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16),
        b"data", struct.pack("<I", data_bytes),
    ])


def pcm16(wav: np.ndarray) -> bytes:
    return (np.clip(wav, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()


def wav_bytes(wav: np.ndarray, sr: int) -> bytes:
    pcm = pcm16(wav)
    return _wav_header(sr, len(pcm)) + pcm


def streaming_wav_header(sr: int) -> bytes:
    """RIFF/WAVE header with unknown (0xFFFFFFFF) sizes, the convention for
    live PCM streams (players read until the socket closes)."""
    return _wav_header(sr)


def make_handler(engine: BatchingEngine, ready: threading.Event, request_timeout: float):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *a):  # quiet per-request noise
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            try:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError):
                # the client hung up mid-response (a health poller with a
                # short timeout): not a server error
                self.close_connection = True

        def _json(self, code: int, obj: dict):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def _error(self, e: BaseException):
            """A request's failure as its HTTP status."""
            if isinstance(e, TimeoutError):
                self._json(504, {"error": "synthesis timed out"})
            elif isinstance(e, ValueError):
                self._json(400, {"error": str(e)})
            else:
                self._json(503 if "overloaded" in str(e) else 500, {"error": str(e)})

        def _chunk(self, data: bytes):
            """One HTTP/1.1 chunked-transfer frame (b'' terminates)."""
            self.wfile.write(f"{len(data):x}\r\n".encode())
            self.wfile.write(data)
            self.wfile.write(b"\r\n")

        def _read_json(self):
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def _stream_response(self, text: str):
            """Chunked streaming WAV: errors before the first audio chunk
            still get a JSON status; after the headers a failure can only
            close the connection."""
            gen = engine.synthesize_stream(text, timeout=request_timeout)
            try:
                first = next(gen, None)
            except (TimeoutError, ValueError, RuntimeError) as e:
                self._error(e)
                return
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            try:
                self._chunk(streaming_wav_header(engine.sample_rate))
                if first is not None:
                    self._chunk(pcm16(first))
                    for piece in gen:
                        self._chunk(pcm16(piece))
                self._chunk(b"")  # terminator
            except (BrokenPipeError, ConnectionResetError):
                for _ in gen:  # the client left; drain so the worker is not blocked
                    pass

        def do_GET(self):
            if self.path == "/healthz":
                if ready.is_set():
                    self._json(200, {"status": "ok"})
                else:
                    self._json(503, {"status": "warming_up"})
            elif self.path == "/stats":
                self._json(200, engine.snapshot())
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path == "/reload":
                try:
                    path = self._read_json()["model"]
                except (ValueError, KeyError) as e:
                    self._json(400, {"error": f"bad request: {e}"})
                    return
                try:
                    t0 = time.time()
                    engine.reload(load_checkpoint(path)["state"])
                except (OSError, KeyError, ValueError, RuntimeError) as e:
                    self._json(400, {"error": f"cannot load {path}: {e}"})
                    return
                self._json(200, {"status": "reloaded", "model": path, "swap_s": round(time.time() - t0, 3)})
                return
            if self.path != "/synthesize":
                self._json(404, {"error": "not found"})
                return
            if not ready.is_set():  # warmup owns the device until every shape has run
                self._json(503, {"error": "warming_up"})
                return
            try:
                req = self._read_json()
                text = req["text"]
            except (ValueError, KeyError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            if req.get("stream"):
                self._stream_response(text)
                return
            t0 = time.time()
            try:
                wav = engine.synthesize(text, timeout=request_timeout)
            except (TimeoutError, ValueError, RuntimeError) as e:
                self._error(e)
                return
            latency = time.time() - t0
            if req.get("format") == "json":
                self._json(200, {
                    "wav_b64": base64.b64encode(wav_bytes(wav, engine.sample_rate)).decode(),
                    "sample_rate": engine.sample_rate,
                    "duration_s": round(wav.shape[0] / engine.sample_rate, 4),
                    "latency_s": round(latency, 4),
                })
            else:
                self._send(200, wav_bytes(wav, engine.sample_rate), "audio/wav")

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-m", "--model", default=None, help="AM checkpoint")
    p.add_argument("--artifact", default=None, metavar="DIR",
                   help="serve the exported programs in DIR (tools/export_tts.py) in place of -m")
    p.add_argument("-c", "--config", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080, help="0 picks a free port")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--window-ms", type=float, default=15.0)
    p.add_argument("--static-frames", type=int, default=None,
                   help="one fixed frame bucket: nothing read back before the waveform")
    p.add_argument("--max-frames", type=int, default=1024,
                   help="serving cap on total frames per utterance (dynamic mode; bounds warmup "
                        "to the reachable frame buckets; 1024 = 12.8 s at 24 kHz/300)")
    p.add_argument("--warmup-streaming", action="store_true",
                   help="force streaming warmup (error if the decoder cannot stream); by default "
                        "streaming is warmed whenever the task can stream")
    p.add_argument("--no-warmup-streaming", action="store_true",
                   help="skip streaming warmup; cold streaming requests are then refused up front")
    p.add_argument("--warmup-only", action="store_true",
                   help="run the warmup, print its seconds and exit without serving")
    p.add_argument("--int8", action="store_true",
                   help="int8 post-training-quantized HiFi-GAN decoder, calibrated on warmup's first batch")
    p.add_argument("--mesh-devices", type=int, default=1, metavar="N",
                   help="serve from N ranks, one process each (0 / -1: every local card); rank 0 serves HTTP")
    p.add_argument("--devices", default=None, help="with --mesh-devices: CUDA indices, one per rank (0,0 shares card 0)")
    p.add_argument("--backend", default=None, help="with --mesh-devices: nccl | gloo (default: nccl, gloo on "
                                                    "the CPU or where ranks share a card)")
    p.add_argument("--sample-rate", type=int, default=None)
    p.add_argument("--max-queue", type=int, default=256)
    p.add_argument("--stream-chunk-frames", type=int, default=64,
                   help="vocoder frames per streamed chunk (64 = 0.8 s at 24 kHz)")
    p.add_argument("--request-timeout", type=float, default=120.0)
    p.add_argument("--no-warmup", action="store_true", help="skip the startup warmup (first requests run cold)")
    p.add_argument("--warmup-lengths", type=int, nargs="*", default=None,
                   help="text lengths to warm (default: the engine's one padded text length; a longer "
                        "length warms its multiple of it)")
    args = p.parse_args(argv)
    if args.mesh_devices != 1 and args.artifact:
        p.error("--artifact serves from one process: drop --mesh-devices")
    if args.artifact:
        fixed = [flag for flag, on in (("-m/--model", args.model), ("--int8", args.int8),
                                       ("--static-frames", args.static_frames)) if on]
        if fixed:
            p.error(f"--artifact serves the export's weights, decoder and frame count: drop {', '.join(fixed)}")
    elif not args.model:
        p.error("one of -m/--model or --artifact is required")
    if args.warmup_streaming and args.no_warmup_streaming:
        p.error("--warmup-streaming conflicts with --no-warmup-streaming")
    if args.mesh_devices != 1:
        try:
            devices, backend = rank_devices(args.mesh_devices, args.device, args.devices, args.backend)
        except ValueError as e:
            p.error(str(e))
        if args.batch_size % len(devices):
            p.error(f"--batch-size {args.batch_size} does not divide the {len(devices)} ranks")
        signal.signal(signal.SIGTERM, _interrupt)  # run_ranks kills the ranks on the way out
        codes = run_ranks(_serve_rank, len(devices), backend, devices, args, timeout_s=float("inf"),
                          group_timeout_s=GROUP_TIMEOUT_S)
        return max(codes)
    return serve(args)


def _interrupt(signum, frame):
    raise KeyboardInterrupt


def _serve_rank(group, device, args) -> int:
    args.device = str(device)
    return serve(args, group)


def serve(args, group=None) -> int:
    """Build the engine and serve (rank 0, or the one process), or follow
    rank 0 (the other ranks of ``group``)."""
    include_streaming = (
        True if args.warmup_streaming
        else False if args.no_warmup_streaming
        else None  # auto: warm streaming whenever the task can stream
    )
    engine = build_engine(args, group)
    if mesh.rank(group) != 0:
        engine.follow()
        return 0

    if args.warmup_only:
        secs = engine.warmup(args.warmup_lengths, include_streaming=include_streaming)
        engine.stop()  # the followers leave their loops
        print(json.dumps({"warmup_s": round(secs, 3), "streaming_warmed": engine._streaming_warm,
                          "shapes": len(engine._warm_shapes), "device": str(engine.task.device),
                          "frame_margin": engine.frame_margin, "ranks": mesh.world(group)}), flush=True)
        return 0

    ready = threading.Event()
    server = ThreadingHTTPServer((args.host, args.port), make_handler(engine, ready, args.request_timeout))

    failed = []

    def _warm():
        # the worker thread warms up before it serves (BatchingEngine.start)
        warmup = None if args.no_warmup else {"text_lengths": args.warmup_lengths,
                                               "include_streaming": include_streaming}
        try:
            engine.start(warmup=warmup)
        except Exception as e:  # a daemon that cannot warm up exits non-zero
            failed.append(e)
            traceback.print_exc()
            engine.stop()  # the followers leave their loops
            server.shutdown()
            return
        if warmup is not None:
            print(f"warmup: ran {len(engine._warm_shapes)} serving shapes in {engine.warmup_s:.3f}s on "
                  f"{engine.task.device} (streaming={'warm' if engine._streaming_warm else 'off'}, "
                  f"frame margin {engine.frame_margin}, ranks {mesh.world(group)}, "
                  f"kernel builds {build_count()})",
                  flush=True)
        ready.set()
        print(f"serving on http://{args.host}:{server.server_port}", flush=True)

    threading.Thread(target=_warm, daemon=True).start()
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        engine.stop()
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
