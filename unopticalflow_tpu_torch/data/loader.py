"""Threaded batch loading and prefetch to the device.

Port of ``unopticalflow_tpu/data/loader.py``.  Samples are pure functions of
their index (the datasets seed their draw from it), so a thread pool decodes
batches ahead of the step, in the JAX loader's index schedule: batch k holds
indices [k*B, (k+1)*B).  Under data parallelism every process builds that
global schedule and loads its own contiguous block of each batch.  ``background`` is that producer
thread for any iterable (the learning harness draws its snippets with it).
``device_prefetch`` keeps the next batches' host-to-device copies in flight
while the current step runs; ``stack_batches`` groups K host batches into
one (K, B, ...) stack for a K-step dispatch before it.
"""

from __future__ import annotations

import collections
import itertools
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from unopticalflow_tpu_torch.parallel.mesh import shard_batch


class BatchLoader:
    """Iterate stacked numpy batches of ``dataset`` with background workers."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 4,
                 prefetch_batches: int = 2, drop_last: bool = False,
                 process_index: int = 0, process_count: int = 1):
        """``batch_size`` is the global batch.  With ``process_count > 1``
        every process builds the same global index schedule and loads only
        block ``process_index`` of ``batch_size // process_count`` of each
        batch (contiguous, as JAX's data mesh holds the rows); a global batch
        that does not divide raises, and a trailing batch that cannot fill
        the global batch is dropped."""
        if batch_size % max(1, process_count):
            raise ValueError(f"global batch {batch_size} must divide over "
                             f"{process_count} processes")
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch_batches = max(1, prefetch_batches)
        self.drop_last = drop_last or process_count > 1
        self.process_index = process_index
        self.process_count = process_count

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
        if self.process_count > 1:
            batches = [shard_batch(b, self.process_index, self.process_count) for b in batches]

        def load():
            with ThreadPoolExecutor(self.num_workers) as pool:
                for idxs in batches:
                    yield self._load_batch(pool, idxs)

        yield from background(load(), self.prefetch_batches)


class _Raised:
    def __init__(self, error: Exception):
        self.error = error


_DONE = object()


def background(items, depth: int = 2):
    """Yield the items of the iterable ``items``, drawn ahead in one thread.

    One producer keeps their order; at most ``depth`` wait in the queue.  An
    exception raised while drawing is raised again in the consumer, and a
    consumer that stops early stops the producer, which then closes ``items``.
    """
    out_q: queue.Queue = queue.Queue(maxsize=max(1, depth))
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
        try:
            for item in items:
                if not put(item):
                    return
        except Exception as e:  # surfaced to the consumer
            put(_Raised(e))
            return
        finally:
            close = getattr(items, "close", None)
            if close is not None:
                close()
        put(_DONE)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = out_q.get()
            if item is _DONE:
                return
            if isinstance(item, _Raised):
                raise item.error
            yield item
    finally:
        stop.set()


def stack_batches(iterator, k: int):
    """Yield ``k`` consecutive host batches of ``iterator`` as one stack: a
    (k, B, ...) array, or a tuple of them for tuple batches (the JAX trainer's
    ``_stack_host_stream``).  Stacked on the host, so one copy of the whole
    stack goes to the device (``device_prefetch``).  A trailing group of
    fewer than ``k`` batches is dropped: the trainer asks for a multiple."""
    iterator = iter(iterator)
    while True:
        group = list(itertools.islice(iterator, k))
        if len(group) < k:
            return
        if isinstance(group[0], tuple):
            yield tuple(np.stack(parts) for parts in zip(*group))
        else:
            yield np.stack(group)


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
