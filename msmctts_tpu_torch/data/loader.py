"""Bucketed data loader with background prefetch (the port's own copy of
``msmctts_tpu/data/loader.py``): worker threads parse cases and collate
static-shape numpy batches; a bounded queue overlaps host-side I/O with the
device step. The permutation of every epoch comes from ``seed + epoch``, as
in the JAX package, so both stacks draw the same batches in the same order.
With ``shard=(rank, world)`` each process takes a contiguous block of every
global batch (see ``_index_stream``). :func:`to_device` moves a numpy batch
to the device as tensors, floats as float32, through pinned memory.
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 2,
        drop_last: bool = True,
        seed: int = 1234,
        shard: Optional[Tuple[int, int]] = None,
        prefetch: int = 4,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(0, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.shard = shard or (0, 1)
        self.prefetch = prefetch
        self.epoch = 0

    def _index_stream(self) -> Iterator[list]:
        """Contiguous-block sharding: every global step consumes one
        world*batch_size slice of the (seed-synchronized) permutation and
        rank r takes rows [r*B, (r+1)*B). Unlike the DistributedSampler's
        strided split, the process shards concatenated in rank order then
        have exactly the single-process row order."""
        rank, world = self.shard
        n = len(self.dataset)
        gb = self.batch_size * world
        while True:
            indices = list(range(n))
            if self.shuffle:
                random.Random(self.seed + self.epoch).shuffle(indices)
            for i in range(0, len(indices), gb):
                chunk = indices[i : i + gb]
                if len(chunk) < gb:
                    if self.drop_last:
                        break
                    chunk = chunk + indices[: gb - len(chunk)]
                yield chunk[rank * self.batch_size : (rank + 1) * self.batch_size]
            self.epoch += 1

    def _make_batch(self, idx_chunk):
        return self.dataset.collate_fn([self.dataset[i] for i in idx_chunk])

    def __iter__(self):
        if self.num_workers == 0:
            for chunk in self._index_stream():
                yield self._make_batch(chunk)
            return

        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        idx_q: queue.Queue = queue.Queue(maxsize=self.prefetch * 2)
        stop = threading.Event()
        stream = self._index_stream()

        def feeder():
            seq = 0
            for chunk in stream:
                if stop.is_set():
                    return
                idx_q.put((seq, chunk))
                seq += 1

        def worker():
            while not stop.is_set():
                try:
                    seq, chunk = idx_q.get(timeout=0.5)
                except queue.Empty:
                    continue
                try:
                    out_q.put((seq, self._make_batch(chunk)))
                except Exception as e:  # surface loader errors to the consumer
                    out_q.put((seq, e))

        threads = [threading.Thread(target=feeder, daemon=True)]
        threads += [threading.Thread(target=worker, daemon=True) for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        # re-order by sequence id so runs are deterministic given a seed
        pending = {}
        next_seq = 0
        try:
            while True:
                while next_seq not in pending:
                    seq, item = out_q.get()
                    pending[seq] = item
                item = pending.pop(next_seq)
                next_seq += 1
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def to_device(batch: dict, device) -> dict:
    """numpy batch -> tensors on ``device``: floating arrays as float32,
    integer arrays as int64; on a GPU through pinned memory, non-blocking."""
    out = {}
    cuda = torch.device(device).type == "cuda"
    for key, value in batch.items():
        arr = np.asarray(value)
        t = torch.from_numpy(np.ascontiguousarray(arr))
        t = t.float() if t.is_floating_point() else t.long()
        out[key] = t.pin_memory().to(device, non_blocking=True) if cuda else t.to(device)
    return out


def finite_loader(dataset, batch_size: int = 1):
    """Sequential single pass over ``dataset`` in order, collated
    (``infer.py``'s loader)."""
    n = len(dataset)
    for i in range(0, n, batch_size):
        yield dataset.collate_fn([dataset[j] for j in range(i, min(n, i + batch_size))])
