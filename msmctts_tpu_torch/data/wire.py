"""Wire format and background device upload of the train feed (the
counterpart of ``msmctts_tpu/data/wire.py``).

* ``encode_batch`` (host): a numpy batch -> host tensors, with JAX's keys and
  rule: a float waveform rides as int16 of ``round(x * 32768)``, clipped (an
  exact round trip for audio read from 16-bit PCM), and in ``"full"`` mode
  the dense float features ``mel`` / ``emb`` / ``pitch`` / ``energy`` as
  bfloat16. Every other array is a tensor as ``loader.host_tensor`` makes
  it: floats float32, integers int64.
* ``decode_batch`` (device): the inverse, keyed on the (key, dtype) pairs
  that ``encode_batch`` produces, never on the dtype alone. The train steps
  call it first, at the sites the JAX package's steps do; on an unencoded
  batch it changes nothing.
* ``DevicePrefetcher``: a worker thread encodes batch N+1, copies it into
  pinned memory and issues its host-to-device copies on a stream of its
  own while the step of batch N runs; an event recorded after the copies
  orders them before the consumer's first use (``__next__`` makes the
  consumer's stream wait on it and marks each tensor as used there).

``dataloader.wire_compression: true | false | full`` selects the mode
(default true: int16 waveforms only, which changes nothing for PCM-sourced
audio) and ``dataloader.device_prefetch`` the depth (default 2). Unlike the
JAX class, a depth of 0 runs no thread: each batch is encoded and copied on
the caller's thread, at ``__next__``.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from msmctts_tpu_torch.data.loader import host_tensor

WAV_SCALE = 32768.0
# dense float features carried as bf16 in "full" mode (never lengths, text,
# durations or ids)
FULL_KEYS = ("mel", "emb", "pitch", "energy")


def encode_batch(batch: dict, mode) -> dict:
    """A numpy batch -> host tensors in the wire format. ``mode``: falsy =
    off, True / ``"wav"`` = int16 waveforms, ``"full"`` = int16 waveforms
    and bf16 dense features (``msmctts_tpu/data/wire.py:43-58``)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            out[k] = v
            continue
        arr = np.asarray(v)
        if mode and k == "wav" and np.issubdtype(arr.dtype, np.floating):
            # numpy's rule (round half to even, clip, cast) in torch's CPU ops:
            # bit-equal, one temporary, and free of the GIL, so the prefetcher's
            # worker takes no host time from the step's thread
            w = torch.from_numpy(np.ascontiguousarray(arr)).mul(WAV_SCALE).round_().clamp_(-32768, 32767)
            out[k] = w.to(torch.int16)
        elif mode == "full" and k in FULL_KEYS and arr.dtype == np.float32:
            out[k] = torch.from_numpy(np.ascontiguousarray(arr)).to(torch.bfloat16)
        else:
            out[k] = host_tensor(arr)
    return out


def decode_batch(batch: dict) -> dict:
    """The inverse of ``encode_batch`` on the device: int16 ``wav`` ->
    float32 / 32768, bf16 ``FULL_KEYS`` -> float32; everything else as it
    is, so a feature natively carried as int16 or bf16 under another key is
    never rescaled (``msmctts_tpu/data/wire.py:61-75``)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            if k == "wav" and v.dtype == torch.int16:
                v = v.float() / WAV_SCALE
            elif k in FULL_KEYS and v.dtype == torch.bfloat16:
                v = v.float()
        out[k] = v
    return out


class DevicePrefetcher:
    """Wraps a host batch iterator: a worker thread encodes and uploads
    ``depth`` batches ahead of the consumer. A loader error reaches the
    consumer at the batch it stopped at, a finite source ends with
    ``StopIteration``, and ``close()`` releases the worker."""

    def __init__(self, it, device, mode=True, depth: int = 2):
        self._it = iter(it)
        self.device = torch.device(device)
        self._mode = mode
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(device=self.device) if self._cuda else None
        self._exc = None
        self._stop = threading.Event()
        self._thread = None
        if depth > 0:
            self._q: queue.Queue = queue.Queue(maxsize=depth)
            self._thread = threading.Thread(target=self._worker, name="device-prefetch", daemon=True)
            self._thread.start()

    def _upload(self, batch: dict):
        host = encode_batch(batch, self._mode)
        if not self._cuda:
            return {k: t.to(self.device) for k, t in host.items()}, None
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            dev = {k: t.pin_memory().to(self.device, non_blocking=True) for k, t in host.items()}
            done = torch.cuda.Event()
            done.record(self._stream)
        return dev, done

    def _worker(self):
        try:
            for batch in self._it:
                if self._stop.is_set() or not self._put(self._upload(batch)):
                    return
            self._put(StopIteration())  # a finite source is exhausted
        except BaseException as e:  # loader and upload errors go to the consumer
            self._put(e)

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if self._exc is not None:
            raise self._exc
        if self._thread is None:
            try:
                item = self._upload(next(self._it))
            except BaseException as e:
                self._exc = e
                raise
        else:
            item = self._q.get()
            if isinstance(item, BaseException):
                self._exc = item
                raise item
        dev, done = item
        if done is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(done)
            for t in dev.values():
                t.record_stream(consumer)  # the allocator keeps it until the consumer's work is done
        return dev

    def close(self, timeout: float = 30.0):
        """Stop the worker, drop what it queued and wait for it to leave the
        source iterator (the caller may close that next)."""
        self._stop.set()
        if self._thread is None:
            return
        while self._thread.is_alive():
            try:
                self._q.get(timeout=0.1)
            except queue.Empty:
                pass
            self._thread.join(timeout=0.1)
            timeout -= 0.2
            if timeout <= 0:
                break
