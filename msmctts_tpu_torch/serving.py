"""TTS serving: dynamic batching over a pinned set of shapes (the
counterpart of ``msmctts_tpu/serving.py``).

Serving from the card adds two constraints the offline path does not have:

- every distinct (batch, text length, frame bucket) shape is new work for
  the card the first time it runs (cuDNN's choice of algorithms, allocator
  growth, the streaming window's shapes), so the engine pins ONE batch
  size, ONE text length and a frame cap (``max_frames``, which clamps
  every utterance's frame total and so makes the reachable frame buckets
  finite), and runs all of it once at
  startup (``warmup``), streaming windows included by default. A deploy
  that opts out of streaming warmup gets cold streaming requests refused up
  front rather than run inside the worker;
- each batch pays a fixed launch cost (some 950 eager launches per
  ``predict`` at the CSMSC widths), so throughput comes from coalescing
  concurrent requests into one batch (dynamic batching with a bounded
  gather window), not from one call per request.

``BatchingEngine`` owns the device: one worker thread drains a queue, pads
requests into the fixed shapes (text to the engine's text length, the
batch by repeating the last row), runs ``MSMCTTS.predict`` (or
``predict_stream``) once, and hands each request its trimmed waveform.

A request decodes the same whichever requests share its batch, which the
JAX package's engine does not promise:

- every batch pads its text to the one text length (a longer request to
  its multiple of it, in a batch of such requests only), where the JAX
  package pads to the bucket of the batch's longest request: the text
  encoder's rounding moves with the padded length, and a nearest-codeword
  snap can turn that into another codeword, whose change the frame
  decoder's attention spreads over the utterance;
- the engine sets the task's ``frame_margin`` to ``padding_reach_frames()``,
  so that the frame bucket keeps after every utterance the padded frames
  that reach its audio; with the JAX package's bucket choice a longer
  batch-mate decides whether there are any.

Callers block on
``synthesize`` or iterate ``synthesize_stream`` from any number of threads.
``serve.py`` wraps this in an HTTP front end.

The engine also serves an exported artifact (``export.ExportedTTS``, whose
``exported`` flag the engine reads once; ``msmctts_tpu/serving.py:468``):
``text_buckets`` are then the artifact's, a request pads to the smallest
bucket that holds it and rides only with requests padded alike, warmup runs
every bucket, and streaming and ``reload`` are refused (an artifact is one
monolithic decode whose weights are part of its programs).

Over an inference group (``group``, a ``parallel.mesh.Group``; the JAX
package's ``mesh``, ``msmctts_tpu/serving.py:168-198``) every rank builds
the engine on its task, which then runs data-parallel
(``MSMCTTS.use_mesh``): ``batch_size`` must divide by the group's size.
Rank 0 holds the queue and the worker thread; the other ranks run
:meth:`BatchingEngine.follow`. For every device operation (a batch, a
streamed batch, warmup, a weight swap, stop) rank 0's worker broadcasts a
header with the padded batch (``mesh.broadcast_object``, over a gloo group
of its own on which followers may wait as long as the daemon idles),
every rank makes the same task calls, and a batch ends with every rank's
status and counters gathered to rank 0 (``mesh.all_gather_objects``). Every
collective is issued by rank 0's worker thread: ``reload`` from an HTTP
thread is queued for the worker. A failure on any rank fails that batch on
rank 0 (a follower's within the group's timeout) and leaves the engine
broken: the ranks may stand at different collectives, so every later
request fails at once, and ``stop`` still ends the followers.

``/stats`` reports, in place of the JAX package's ``xla_compiles``,
``cold_shapes`` (shapes the task first ran after ``warmup()`` ended, from
``MSMCTTS.shapes``) and ``kernel_builds`` (nvcc builds in this process
since ``warmup()`` ended, from ``ops/cuda_build.build_count``). A warmed
server reports 0 for both under any traffic within its buckets. Over a
group both are summed over the ranks, and ``ranks`` lists each rank's, as
the followers reported them at their last batch's end.
``task_realtime_factor`` is the audio served over the host's wall time in
the task calls.

The worker records the spans of ``utils/tracing.py``: ``engine.wait`` (an
empty queue), ``engine.gather`` (the gather window), ``engine.pad``,
``engine.task`` and ``engine.deliver`` for every batch, which together take
the worker's whole loop, and ``request`` with its child ``request.queue``
for every request it serves.
"""

from __future__ import annotations

import bisect
import itertools
import math
import queue
import random
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from msmctts_tpu_torch.data.datasets import FRAME_BUCKETS, TEXT_BUCKETS, bucket_length
from msmctts_tpu_torch.ops.cuda_build import build_count
from msmctts_tpu_torch.parallel import mesh
from msmctts_tpu_torch.utils.tracing import record, span

__all__ = ["BatchingEngine", "ServingStats", "parse_phone_string"]


def parse_phone_string(text: str) -> np.ndarray:
    """``"3_1 5_2 7_0"`` -> int32 [L, n_streams] (synthesize.py contract)."""
    tokens = [[int(x) for x in tok.split("_")] for tok in text.split() if tok]
    if not tokens:
        raise ValueError("empty phone string")
    widths = {len(t) for t in tokens}
    if len(widths) != 1:
        raise ValueError(f"inconsistent token widths {sorted(widths)}")
    return np.asarray(tokens, np.int32)


@dataclass
class ServingStats:
    """Cumulative counters and a bounded latency reservoir (guarded by the
    engine's lock; percentiles are approximate under load). ``busy_seconds``
    is the host's wall time inside the task calls (the ``engine.task``
    spans), device time and host time alike."""

    requests: int = 0
    batches: int = 0
    errors: int = 0
    audio_seconds: float = 0.0
    busy_seconds: float = 0.0
    started_at: float = field(default_factory=time.time)
    _latencies: List[float] = field(default_factory=list)
    _MAX_LAT = 4096

    def record_latency(self, seconds: float) -> None:
        if len(self._latencies) >= self._MAX_LAT:
            # evict a uniformly random victim: deleting a fixed position
            # hollows out that part of the distribution
            del self._latencies[random.randrange(len(self._latencies))]
        bisect.insort(self._latencies, seconds)

    def snapshot(self, sample_rate: int, cold_shapes: int = 0, kernel_builds: int = 0) -> dict:
        lat = self._latencies
        pct = lambda p: (lat[min(len(lat) - 1, int(p * len(lat)))] if lat else None)
        uptime = time.time() - self.started_at
        return {
            "requests": self.requests,
            "batches": self.batches,
            "errors": self.errors,
            "cold_shapes": cold_shapes,
            "kernel_builds": kernel_builds,
            "mean_batch_size": (self.requests / self.batches) if self.batches else None,
            "audio_seconds": round(self.audio_seconds, 3),
            "task_realtime_factor": (
                round(self.audio_seconds / self.busy_seconds, 1) if self.busy_seconds > 0 else None
            ),
            "latency_s": {"p50": pct(0.50), "p95": pct(0.95), "p99": pct(0.99)},
            "uptime_s": round(uptime, 1),
            "sample_rate": sample_rate,
        }


_request_ids = itertools.count(1)


class _Request:
    __slots__ = ("id", "text", "done", "wav", "error", "t_enqueue", "stream", "chunk_q")

    def __init__(self, text: np.ndarray, stream: bool = False):
        self.id = next(_request_ids)  # the ``request`` attribute of its spans
        self.text = text  # int32 [L, n_streams]
        self.done = threading.Event()
        self.wav: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.t_enqueue = time.perf_counter()
        self.stream = stream
        # streaming requests receive trimmed wav pieces here, then a None
        # sentinel (or one BaseException)
        self.chunk_q: Optional[queue.Queue] = queue.Queue() if stream else None


class _Reload:
    """A weight swap over a group, queued for the worker so that its
    collectives run on the worker's thread."""

    __slots__ = ("state", "done", "error")
    stream = False

    def __init__(self, state: dict):
        self.state = state
        self.done = threading.Event()
        self.error: Optional[BaseException] = None


def _fail(req: _Request, error: BaseException) -> None:
    """Deliver ``error`` to a waiting request (and its stream)."""
    req.error = error
    if req.stream:
        req.chunk_q.put(error)
    req.done.set()


class BatchingEngine:
    """Dynamic-batching front end over ``MSMCTTS.predict``.

    Parameters
    ----------
    task: an infer-mode ``MSMCTTS`` task with its weights loaded.
    sample_rate: output audio rate (config ``dataset.samplerate``).
    batch_size: the ONE pinned batch size. Smaller batches are padded up by
        repeating the last request's row; larger gathers are split.
    window_ms: how long the worker waits for followers after the first
        request of a batch arrives. 0 disables coalescing (latency mode).
    text_length: the ONE padded text length (phones). A longer request is
        padded to its multiple of it and rides only with requests padded
        alike.
    max_frames: serving cap on each utterance's frame total (audio past it
        is truncated). In dynamic-bucket mode it bounds the reachable frame
        buckets, so ``warmup`` can run them all.
        Clamped to the ``FRAME_BUCKETS`` ladder's top.
    max_queue: backpressure bound; ``synthesize`` raises when it is full.
    stream_chunk_frames: decoder frames per streamed chunk.
    text_buckets: padded text lengths in place of ``text_length`` (an
        exported artifact's): a request pads to the smallest that holds it;
        a longer one is refused.
    group: a ``parallel.mesh.Group`` to serve from all its ranks (see the
        module docstring); every rank builds the engine, rank 0 serves and
        the others call :meth:`follow`. ``batch_size`` must divide by its
        size.
    """

    def __init__(
        self,
        task,
        sample_rate: int,
        batch_size: int = 8,
        window_ms: float = 15.0,
        text_length: int = TEXT_BUCKETS[-1],
        max_frames: int = FRAME_BUCKETS[-1],
        max_queue: int = 256,
        stream_chunk_frames: int = 64,
        text_buckets: Optional[Sequence[int]] = None,
        group=None,
    ):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        W = mesh.world(group)
        if batch_size % W:
            raise ValueError(f"batch_size {batch_size} does not divide the {W}-rank inference group")
        self.group = group if W > 1 else None
        self.rank = mesh.rank(group)
        if self.group is not None:
            if getattr(task, "exported", False):
                raise ValueError("an exported artifact serves from one process")
            task.use_mesh(group)
            # followers wait here for rank 0's next header however long it idles
            self._channel = mesh.new_control_group(group, timeout_s=10 * 365 * 86400.0)
        self._broken: Optional[str] = None  # why the group can no longer serve
        self._released = False  # rank 0 has sent the followers "stop"
        self._rank_counters: dict = {}  # rank -> (cold_shapes, kernel_builds) at its last batch's end
        self.max_frames = min(int(max_frames), FRAME_BUCKETS[-1])
        # an exported artifact (export.ExportedTTS) is fixed programs: no
        # networks to read, no frame buckets, streaming or reload
        self.exported = bool(getattr(task, "exported", False))
        self.can_stream = hasattr(task, "predict_stream") and not self.exported
        if hasattr(task, "max_frames_cap"):
            task.max_frames_cap = self.max_frames
        if hasattr(task, "frame_margin"):
            # a request decodes the same whichever requests share its batch:
            # the frame bucket keeps every padded frame that reaches its audio
            task.frame_margin = task.padding_reach_frames()
        self.task = task
        self.sample_rate = int(sample_rate)
        self.batch_size = int(batch_size)
        self.window_ms = float(window_ms)
        self.stream_chunk_frames = int(stream_chunk_frames)
        self.text_length = int(text_length)
        self.text_buckets = tuple(sorted(int(b) for b in text_buckets)) if text_buckets else None
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue(maxsize=max_queue)
        self._held: List[_Request] = []  # taken from the queue for a later batch (worker thread only)
        self._lock = threading.Lock()
        # Serializes batches against weight swaps (``reload``).
        self._model_lock = threading.Lock()
        self.stats = ServingStats()
        self._batch_ids = itertools.count(1)  # the ``batch`` attribute of the worker's spans
        self._batch_id = 0  # the batch the worker gathers or runs (worker thread only)
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        # warmup() sets these; once _warmed, a streaming request whose
        # shapes were NOT warmed is refused up front instead of running
        # cold inside the worker thread (where it would stall queued traffic).
        self._warmed = False
        self._streaming_warm = False
        self._warm_shapes: frozenset = frozenset()
        self._warm_builds = 0  # build_count() when warmup ended
        self.warmup_s: Optional[float] = None  # set by start(warmup=...)

    # -- lifecycle -----------------------------------------------------

    def start(self, warmup: Optional[dict] = None) -> "BatchingEngine":
        """Start the worker thread. With ``warmup`` (``warmup()``'s keyword
        arguments) the worker runs the warmup before it takes a request, and
        this call returns once it has, raising what the warmup raised; the
        seconds are in ``warmup_s``. A serving deploy warms this way:
        PyTorch keeps cuDNN's execution plans per thread, so shapes warmed
        on another thread run cold in the worker's first batches."""
        if self._thread is not None:
            raise RuntimeError("engine already started")
        self._stopping = False
        warmed, failed = threading.Event(), []

        def run():
            if warmup is not None:
                try:
                    self.warmup_s = self.warmup(**warmup)
                except Exception as e:  # raised by start() in the caller's thread
                    failed.append(e)
                    warmed.set()
                    return
            warmed.set()
            self._worker()

        self._thread = threading.Thread(target=run, name="tts-batcher", daemon=True)
        self._thread.start()
        warmed.wait()
        if failed:
            self._thread.join()
            self._thread = None
            raise failed[0]
        return self

    def stop(self, timeout: float = 30.0) -> None:
        if self._thread is None:
            self._release_followers()  # a group that only warmed up (serve --warmup-only)
            return
        self._stopping = True
        self._fail_queued()  # also makes room for the wake-up below
        try:
            self._queue.put_nowait(None)  # wake the worker
        except queue.Full:  # refilled meanwhile: the worker is busy and sees _stopping after its batch
            pass
        self._thread.join(timeout=timeout)
        self._thread = None
        self._fail_queued()

    def _fail_queued(self) -> None:
        """Fail every request still in the queue ("engine stopped"); the
        worker fails those it holds back when it exits."""
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            if req is not None:
                _fail(req, RuntimeError("engine stopped"))

    @property
    def frame_margin(self) -> int:
        """Padded frames a request's bucket keeps past its total (none for
        a task without a margin, an exported artifact among them)."""
        return int(getattr(self.task, "frame_margin", 0))

    def _own_cold_shapes(self) -> int:
        return len(getattr(self.task, "shapes", set()) - self._warm_shapes)

    def _own_kernel_builds(self) -> int:
        return build_count() - self._warm_builds

    def _counters(self) -> dict:
        """rank -> (cold_shapes, kernel_builds): this process's now, the
        followers' as they reported them."""
        return {**self._rank_counters, self.rank: (self._own_cold_shapes(), self._own_kernel_builds())}

    def cold_shapes(self) -> int:
        """Shapes the task first ran after ``warmup()`` ended (all of them
        when no warmup ran), summed over the group's ranks."""
        return sum(c for c, _ in self._counters().values())

    def kernel_builds(self) -> int:
        """nvcc builds since ``warmup()`` ended (all of them when no warmup
        ran), summed over the group's ranks."""
        return sum(b for _, b in self._counters().values())

    def snapshot(self) -> dict:
        """``/stats``: the counters, ``cold_shapes`` and ``kernel_builds``
        (and each rank's, over a group)."""
        with self._lock:
            snap = self.stats.snapshot(self.sample_rate, cold_shapes=self.cold_shapes(),
                                       kernel_builds=self.kernel_builds())
            if self.group is not None:
                snap["ranks"] = [{"rank": r, "cold_shapes": c, "kernel_builds": b}
                                 for r, (c, b) in sorted(self._counters().items())]
                snap["group_failed"] = self._broken
            return snap

    def warmup(
        self,
        text_lengths: Optional[Sequence[int]] = None,
        include_streaming: Optional[bool] = None,
    ) -> float:
        """Run every shape a request can reach, once.

        Per padded text length (the engine's, and the multiples of it that
        ``text_lengths`` reach past it): one predicted-duration pass (the
        ``("dur", Lt)`` shape plus whatever frame bucket the random warmup
        text lands in), then, in dynamic-bucket mode, one forced-duration
        pass per reachable frame bucket, which drives the exact
        ``("syn", Lt, F)`` shape the live two-phase path uses. The
        ``max_frames`` cap is what makes that product finite; in
        static-frames mode there is one frame bucket per text length, which
        the first pass already covers.

        ``include_streaming`` also drains one ``predict_stream`` per (text
        length, frame bucket), warming the window decode. ``None`` (the
        default) warms streaming whenever the task can stream, because any
        client can ask for it; ``False`` opts out, and cold streaming
        requests are then refused up front.

        Warmup text is random phone ids from the model's vocabulary, so the
        duration predictor sees in-distribution input. Returns the wall
        seconds spent. Run it before accepting traffic, on the thread that
        will serve: ``start(warmup=...)``.
        """
        self._announce("warmup", {"text_lengths": text_lengths, "include_streaming": include_streaming})
        return self._on_group(lambda: self._warmup(text_lengths, include_streaming))

    def _warmup(self, text_lengths, include_streaming) -> float:
        stream = include_streaming
        if stream is None:
            stream = self.can_stream
        default = self.text_buckets or [self.text_length]
        lengths = sorted({self._text_length(l) for l in (text_lengths or default)})
        frame_buckets = self._reachable_frame_buckets()
        t0 = time.time()
        with self._model_lock:
            for L in lengths:
                batch = {
                    "text": self._warmup_text(L),
                    "text_length": np.full((self.batch_size,), L, np.int32),
                }
                self.task.infer_step(batch)
                if stream and self.can_stream and not frame_buckets:
                    stream = self._try_drain_stream(batch, include_streaming)
                for F in frame_buckets:
                    # the total whose bucket, past the task's margin, is F
                    total = max(F - self.frame_margin, 1)
                    forced = dict(batch, dur=self._forced_durations(L, total))
                    self.task.infer_step(forced)
                    if stream and self.can_stream:
                        stream = self._try_drain_stream(forced, include_streaming)
            self._warmed = True
            self._streaming_warm = bool(stream) and self.can_stream
            self._warm_shapes = frozenset(getattr(self.task, "shapes", ()))
            self._warm_builds = build_count()
        return time.time() - t0

    def _try_drain_stream(self, batch: dict, explicit: Optional[bool]) -> bool:
        """Drain one streaming warmup pass. In auto mode (``explicit is
        None``) a decoder that cannot stream just turns streaming warmup
        off; an explicit ``include_streaming=True`` propagates the error."""
        try:
            self._drain_stream(batch)
            return True
        except NotImplementedError:
            if explicit:
                raise
            return False

    def _reachable_frame_buckets(self) -> List[int]:
        """The frame buckets a live request can select in dynamic-bucket
        mode: every ``FRAME_BUCKETS`` entry between the model's minimum
        bucket (the scale lcm) and ``bucket_length(max_frames)``. Empty in
        static-frames mode."""
        task = self.task
        if self.exported or getattr(task, "static_max_frames", None):
            return []
        predictor = task.networks.get("predictor")
        if predictor is None:  # autoencoder-only task: no two-phase path
            return []
        scales = list(predictor.n_pred_scale)
        lo = bucket_length(math.lcm(*scales) if scales else 1, FRAME_BUCKETS)
        hi = max(lo, bucket_length(self.max_frames, FRAME_BUCKETS))
        return [b for b in FRAME_BUCKETS if lo <= b <= hi]

    def _warmup_text(self, L: int) -> np.ndarray:
        """Random phone ids [B, L, n_streams], drawn per stream from the
        model's vocabulary (0 is padding; an artifact carries no vocabulary:
        id 1)."""
        if self.exported:
            n_symbols = [2] * self._n_streams()
        else:
            ns = self.task.networks["predictor"].n_symbols
            n_symbols = list(ns) if isinstance(ns, (list, tuple)) else [ns]
        rng = np.random.default_rng(0)
        cols = [rng.integers(1, max(int(n), 2), size=(self.batch_size, L)) for n in n_symbols]
        return np.stack(cols, axis=-1).astype(np.int32)

    def _forced_durations(self, L: int, total_frames: int) -> np.ndarray:
        """Per-symbol frame durations [B, L] summing exactly to
        ``total_frames``: drives ``_predict_phase1`` straight into that
        frame bucket."""
        base = total_frames // L
        dur = np.full((self.batch_size, L), base, np.float32)
        dur[:, 0] += total_frames - base * L
        return dur

    def _drain_stream(self, batch: dict) -> None:
        _, chunks = self.task.predict_stream(batch, chunk_frames=self.stream_chunk_frames)
        for _ in chunks:
            pass

    def reload(self, state: dict) -> None:
        """Swap the model's weights with no downtime. ``state`` is a
        checkpoint state tree (``load_checkpoint(path)["state"]``). The swap
        happens between batches: a batch in flight finishes on the old
        weights, queued ones run on the new. The fused MRF layers' prepared
        taps are rebuilt by ``ResBlock1.fold`` on load; an int8 decoder is
        dropped by the load and quantized and calibrated again on the next
        batch (its shapes stay warm: they are the same shapes). An exported
        artifact refuses it (``msmctts_tpu/serving.py:383-387``)."""
        if self.exported:
            raise RuntimeError("hot reload needs the checkpoint-backed task path; "
                               "exported artifacts are immutable")
        if self.group is not None and self._thread is not None:
            # the swap's broadcast must run on the worker's thread
            swap = _Reload(state)
            self._queue.put(swap)
            swap.done.wait()
            if swap.error is not None:
                raise swap.error
            return
        self._reload(state)

    def _reload(self, state: dict) -> None:
        with self._model_lock:
            self._announce("reload", state)
            self._on_group(lambda: self.task.load_variables(state))

    # -- the group -----------------------------------------------------

    def _announce(self, kind: str, payload=None) -> None:
        """Rank 0: send the next device operation's header (and its batch)
        to the followers. Raises once the group has failed."""
        if self.group is None or self.rank != 0:
            return
        if self._broken is not None:
            raise RuntimeError(f"the inference group failed earlier: {self._broken}")
        mesh.broadcast_object((kind, payload), self.group, control=self._channel)

    def _on_group(self, fn):
        """Run this rank's share of a device operation, then gather every
        rank's status and counters; a failure anywhere fails the operation
        (on rank 0) and breaks the group."""
        if self.group is None:
            return fn()
        try:
            result = fn()
        except BaseException as e:
            self._broken = self._broken or f"rank {self.rank}: {type(e).__name__}: {e}"
            raise
        status = mesh.all_gather_objects((self._own_cold_shapes(), self._own_kernel_builds()), self.group)
        with self._lock:
            self._rank_counters = dict(enumerate(status))
        return result

    def _release_followers(self) -> None:
        """Rank 0: end the followers' loops (once)."""
        if self.group is not None and self.rank == 0 and not self._released:
            self._released = True
            mesh.broadcast_object(("stop", None), self.group, control=self._channel)

    def follow(self) -> None:
        """A follower's loop (ranks other than 0): receive each header from
        rank 0 and make the same task calls, until ``stop``. After a
        failure it only waits for ``stop``."""
        if self.group is None or self.rank == 0:
            raise RuntimeError("follow() runs on the followers of an inference group")
        while True:
            kind, payload = mesh.broadcast_object(None, self.group, control=self._channel)
            if kind == "stop":
                return
            if self._broken is not None:
                continue
            try:
                if kind == "warmup":
                    self._on_group(lambda: self._warmup(**payload))
                elif kind == "reload":
                    self._on_group(lambda: self.task.load_variables(payload))
                elif kind == "predict":
                    self._on_group(lambda: self.task.infer_step(payload))
                elif kind == "stream":
                    self._on_group(lambda: self._drain_stream(payload))
                else:
                    raise RuntimeError(f"unknown header {kind!r}")
            except Exception:  # recorded in _broken; rank 0 fails the batch
                continue

    # -- request path --------------------------------------------------

    def synthesize(self, text, timeout: Optional[float] = None) -> np.ndarray:
        """Blocking synthesis: phone tokens in, trimmed float32 wav out.

        ``text`` is an int array [L, n_streams] or a phone string
        (``parse_phone_string``). Thread-safe; raises on engine errors,
        backpressure overflow, or timeout.
        """
        req = self._submit(text, stream=False)
        if not req.done.wait(timeout=timeout):
            raise TimeoutError("synthesis timed out")
        if req.error is not None:
            raise req.error
        return req.wav

    def synthesize_stream(self, text, timeout: Optional[float] = None,
                          first_chunk_timeout: Optional[float] = None):
        """Streaming synthesis: yields trimmed float32 wav pieces of ONE
        utterance as the decoder produces them (``task.predict_stream``:
        their concatenation is the monolithic waveform). The acoustic model
        still rides the dynamic batch; only the vocoder is chunked.

        ``timeout`` bounds each wait between chunks; the first one may be
        bounded apart by ``first_chunk_timeout`` (it includes the gather
        window and the acoustic model)."""
        req = self._submit(text, stream=True)
        deadline = first_chunk_timeout or timeout
        while True:
            try:
                item = req.chunk_q.get(timeout=deadline)
            except queue.Empty:
                raise TimeoutError("streaming synthesis timed out")
            deadline = timeout
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def _submit(self, text, stream: bool) -> _Request:
        if isinstance(text, str):
            text = parse_phone_string(text)
        text = np.asarray(text, np.int32)
        if text.ndim == 1:  # single-stream models take [L] -> [L, 1]
            text = text[:, None]
        if text.ndim != 2 or text.shape[0] == 0:
            raise ValueError(f"text must be [L, n_streams], got {text.shape}")
        want = self._n_streams()
        if text.shape[1] != want:
            raise ValueError(f"model takes {want}-stream phone tokens, got {text.shape[1]}")
        if self.text_buckets and text.shape[0] > self.text_buckets[-1]:
            raise ValueError(f"no exported module for text length {text.shape[0]}; have {list(self.text_buckets)}")
        if self._thread is None:
            raise RuntimeError("engine not started")
        if stream and self.exported:
            raise RuntimeError("streaming needs the task path (serve -m <checkpoint>); an exported program is one "
                               "monolithic decode")
        if stream and self._warmed and not self._streaming_warm:
            # Refuse here, in the caller's thread, instead of letting the
            # first cold streaming request run new shapes inside the worker
            # and stall every queued request.
            raise RuntimeError(
                "streaming shapes are cold: warmup ran without streaming "
                "(opted out, or the decoder cannot stream); restart with "
                "streaming warmup or use blocking synthesis"
            )
        req = _Request(text, stream=stream)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            with self._lock:
                self.stats.errors += 1
            raise RuntimeError("server overloaded (queue full)")
        return req

    # -- worker --------------------------------------------------------

    def _n_streams(self) -> int:
        if self.exported:
            return int(self.task.n_streams)
        n_symbols = self.task.networks["predictor"].n_symbols
        return len(n_symbols) if isinstance(n_symbols, (list, tuple)) else 1

    def _text_length(self, n: int) -> int:
        """The padded text length of an n-phone request: the smallest of the
        ``text_buckets`` that holds it; without them the engine's text length,
        or past it its multiple of it."""
        if self.text_buckets:
            return bucket_length(n, self.text_buckets)
        return bucket_length(n, (self.text_length,))

    def _gather(self) -> Optional[List[_Request]]:
        """The next batch: the oldest waiting request, then followers of its
        padded text length, for up to ``window_ms`` or until ``batch_size``
        is reached. A request padded otherwise (longer than the engine's
        text length) waits, in arrival order, for a later batch. The wait
        for a first request on an empty queue is the span ``engine.wait``,
        the rest ``engine.gather``, both of the next batch id."""
        self._batch_id = next(self._batch_ids)
        if self._held:
            first = self._held.pop(0)
        else:
            with span("engine.wait", batch=self._batch_id):
                first = self._queue.get()
        if first is None or isinstance(first, _Reload):
            return first
        with span("engine.gather", batch=self._batch_id):
            Lt, held = self._text_length(first.text.shape[0]), []
            reqs = [first]
            for r in self._held:
                joins = (len(reqs) < self.batch_size and not isinstance(r, _Reload)
                         and self._text_length(r.text.shape[0]) == Lt)
                (reqs if joins else held).append(r)
            self._held = held
            deadline = time.time() + self.window_ms / 1000.0
            while len(reqs) < self.batch_size:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._queue.put(None)  # re-post the stop sentinel
                    break
                if isinstance(nxt, _Reload):  # runs after this batch
                    self._held.append(nxt)
                    break
                (reqs if self._text_length(nxt.text.shape[0]) == Lt else self._held).append(nxt)
        return reqs

    def batch_of(self, texts: List[np.ndarray]) -> dict:
        """The task batch of these phone arrays ([L, n_streams] each): text
        padded to the engine's text length, the batch to ``batch_size`` by
        repeating the last real row, which keeps the one (B, Lt) shape for
        any arrival count."""
        lengths = [t.shape[0] for t in texts]
        Lt = self._text_length(max(lengths))
        B = self.batch_size
        text = np.zeros((B, Lt, self._n_streams()), np.int32)
        for i, t in enumerate(texts):
            text[i, : t.shape[0]] = t
        for i in range(len(texts), B):
            text[i] = text[len(texts) - 1]
        text_length = np.asarray(lengths + [lengths[-1]] * (B - len(texts)), np.int32)
        return {"text": text, "text_length": text_length}

    def _run_batch(self, reqs: List[_Request]) -> None:
        """Pad, run and deliver one gathered batch: the spans
        ``engine.pad``, ``engine.task`` (real ``rows``) and
        ``engine.deliver`` (``served_frames``, the real rows' frame totals,
        where the task reports them), each of the ``batch`` id, then for
        every request ``request`` (enqueue to delivery) and its child
        ``request.queue`` (enqueue to this batch)."""
        taken, bid = time.perf_counter(), self._batch_id
        with span("engine.pad", batch=bid):
            batch = self.batch_of([r.text for r in reqs])
        streaming = any(r.stream for r in reqs)
        with span("engine.task", batch=bid, rows=len(reqs)) as task:
            if streaming:
                self._announce("stream", batch)
                audio = self._on_group(lambda: self._run_streaming(reqs, batch))
            else:
                self._announce("predict", batch)
                out = self._on_group(lambda: self.task.infer_step(batch))
        with span("engine.deliver", batch=bid) as deliver:
            if not streaming:
                audio = 0.0
                for i, r in enumerate(reqs):
                    r.wav = np.asarray(out["wav"][i])
                    audio += r.wav.shape[0] / self.sample_rate
                    r.done.set()
                if "mel_length" in out:  # an exported artifact reports waveforms alone
                    deliver.attrs["served_frames"] = int(np.sum(out["mel_length"][: len(reqs)]))
            done = time.perf_counter()
            with self._lock:
                self.stats.batches += 1
                self.stats.requests += len(reqs)
                self.stats.audio_seconds += audio
                self.stats.busy_seconds += task.t1 - task.t0
                for r in reqs:
                    self.stats.record_latency(done - r.t_enqueue)
            for r in reqs:
                rid = record("request", r.t_enqueue, done, request=r.id, batch=bid)
                record("request.queue", r.t_enqueue, taken, parent=rid, request=r.id, batch=bid)

    def _run_streaming(self, reqs: List[_Request], batch: dict) -> float:
        """Drive ``task.predict_stream`` for a batch that holds streaming
        requests: every decoder chunk is sliced per utterance and pushed to
        the streaming requests at once; blocking requests of the same batch
        get the concatenation. Returns audio seconds."""
        meta, chunks = self.task.predict_stream(batch, chunk_frames=self.stream_chunk_frames)
        wav_len = meta["wav_length"]
        acc: List[list] = [[] for _ in reqs]
        off = 0
        for chunk in chunks:
            n = chunk.shape[1]
            for i, r in enumerate(reqs):
                lo, hi = off, min(off + n, int(wav_len[i]))
                if hi <= lo:
                    continue
                piece = np.asarray(chunk[i, : hi - lo])
                if r.stream:
                    r.chunk_q.put(piece)
                else:
                    acc[i].append(piece)
            off += n
        audio = 0.0
        for i, r in enumerate(reqs):
            audio += int(wav_len[i]) / self.sample_rate
            if r.stream:
                r.chunk_q.put(None)
            else:
                r.wav = np.concatenate(acc[i]) if acc[i] else np.zeros((0,), np.float32)
            r.done.set()
        return audio

    def _worker(self) -> None:
        try:
            while not self._stopping:
                reqs = self._gather()
                if reqs is None:
                    return
                if isinstance(reqs, _Reload):
                    try:
                        self._reload(reqs.state)
                    except Exception as e:
                        reqs.error = e
                    reqs.done.set()
                    continue
                try:
                    with self._model_lock:
                        self._run_batch(reqs)
                except Exception as e:  # deliver, don't kill the worker
                    with self._lock:
                        self.stats.errors += len(reqs)
                    for r in reqs:
                        _fail(r, e)
        finally:
            held, self._held = self._held, []
            for r in held:
                _fail(r, RuntimeError("engine stopped"))
            self._release_followers()
