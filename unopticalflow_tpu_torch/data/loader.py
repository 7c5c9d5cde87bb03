"""Threaded batch loading and prefetch to the device.

Port of ``unopticalflow_tpu/data/loader.py`` (one process).  Samples are pure
functions of their index (the datasets seed their draw from it), so a thread
pool decodes batches ahead of the step, in the JAX loader's index schedule:
batch k holds indices [k*B, (k+1)*B).  ``device_prefetch`` keeps the next
batches' host-to-device copies in flight while the current step runs.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


class BatchLoader:
    """Iterate stacked numpy batches of ``dataset`` with background workers."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 4,
                 prefetch_batches: int = 2, drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch_batches = max(1, prefetch_batches)
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _load_batch(self, pool, indices):
        samples = list(pool.map(self.dataset.__getitem__, indices))
        if isinstance(samples[0], tuple):
            return tuple(np.stack(parts, 0) for parts in zip(*samples))
        return np.stack(samples, 0)

    def __iter__(self):
        n = len(self.dataset)
        batches = [list(range(s, min(s + self.batch_size, n)))
                   for s in range(0, n, self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()

        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()

        def put(item) -> bool:
            """Queue-put that stays responsive to stop (consumer gone)."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            with ThreadPoolExecutor(self.num_workers) as pool:
                for idxs in batches:
                    if stop.is_set():
                        return
                    try:
                        batch = self._load_batch(pool, idxs)
                    except Exception as e:  # surface worker errors to the consumer
                        put(e)
                        return
                    if not put(batch):
                        return
                put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def _map(fn, batch):
    return tuple(fn(x) for x in batch) if isinstance(batch, tuple) else fn(batch)


def device_prefetch(iterator, device, depth: int = 2):
    """Yield the batches of ``iterator`` (numpy) as tensors on ``device``.

    On CUDA: each batch is copied into pinned host memory and sent with a
    ``non_blocking`` copy on a side stream, ``depth`` batches ahead; the
    consumer's stream waits for the copy's event before it uses the batch.
    On the CPU: a plain conversion.  The path is chosen by ``device`` as
    passed, never by what the machine has.
    """
    device = torch.device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield _map(lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device), batch)
        return

    copy_stream = torch.cuda.Stream(device)
    inflight = collections.deque()
    for batch in iterator:
        host = _map(lambda x: torch.from_numpy(np.ascontiguousarray(x)).pin_memory(), batch)
        with torch.cuda.stream(copy_stream):
            dev = _map(lambda t: t.to(device, non_blocking=True), host)
            done = torch.cuda.Event()
            done.record(copy_stream)
        inflight.append((dev, done))
        if len(inflight) >= depth:
            yield _ready(*inflight.popleft(), device)
    while inflight:
        yield _ready(*inflight.popleft(), device)


def _ready(dev, done, device):
    consumer = torch.cuda.current_stream(device)
    consumer.wait_event(done)
    # the batch was allocated on the copy stream: tell the caching allocator
    # that the consumer's stream uses it too
    _map(lambda t: t.record_stream(consumer), dev)
    return dev
