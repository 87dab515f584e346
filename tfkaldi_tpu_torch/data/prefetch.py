"""Asynchronous batch prefetching with pinned host buffers.

Port of :mod:`tfkaldi_tpu.data.prefetch`. A worker thread stays ``depth``
batches ahead: it pulls utterances from the dispenser, pads them
(:class:`~tfkaldi_tpu_torch.data.batching.DeviceBatcher`) and, for a CUDA
device, copies the padded arrays into pinned host tensors. The consumer
(:meth:`PrefetchingBatchSource.next`) issues the host→device copy with
``non_blocking=True`` on its current stream, so the copy overlaps the
previous step's device work. The worker's batch build runs under a
``prefetch.build`` ``torch.profiler`` span on its own thread, and
:meth:`~PrefetchingBatchSource.next` (the queue wait and the copy's
enqueue) under ``prefetch.next`` on the consumer's.

A pinned buffer must outlive its asynchronous copy: freeing or reusing it
earlier corrupts a batch, and only on the card. Each consumed host batch
is therefore kept, with a CUDA event recorded after its copy, until that
event has completed; :meth:`close` waits for the rest.

Rollback support: the training controller's validation rewind must also
un-read whatever the prefetcher has buffered. ``rewind(n)`` stops the
worker, drops the queue, and rewinds the dispenser by ``n`` plus every
batch pulled from the dispenser but not yet consumed (including one
potentially in flight inside the worker).
"""

from __future__ import annotations

import collections
import queue
import threading

import torch

from tfkaldi_tpu_torch.data.batching import DeviceBatcher, PaddedBatch
from tfkaldi_tpu_torch.data.dispenser import BatchDispenser
from tfkaldi_tpu_torch.device import resolve_device

_WORKER_FAILED = object()  # queue sentinel: worker thread died, see _error


class PrefetchingBatchSource:
    """Pulls batches from a dispenser on a worker thread; :meth:`next`
    returns them as tensors on ``device`` (``cuda`` unless the caller names
    the CPU)."""

    def __init__(
        self,
        dispenser: BatchDispenser,
        batcher: DeviceBatcher,
        depth: int = 2,
        device: str | torch.device = "cuda",
    ):
        self.dispenser = dispenser
        self.batcher = batcher
        self.depth = max(1, int(depth))
        self.device = resolve_device(device)
        self._pin = self.device.type == "cuda"
        self._queue: queue.Queue = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._lock = threading.Lock()  # guards dispenser cursor + _in_flight
        self._in_flight = 0  # batches read from the dispenser, not yet consumed
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        # consumed pinned batches whose copies may still be running
        self._copies: collections.deque = collections.deque()
        self._start_worker()

    # ------------------------------------------------------------------

    def _start_worker(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        try:
            while not self._stop.is_set():
                with torch.profiler.record_function("prefetch.build"):
                    with self._lock:
                        if self._stop.is_set():
                            return
                        host_batch = self.dispenser.get_padded_batch(self.batcher)
                        self._in_flight += 1
                    tensors = (torch.from_numpy(a) for a in host_batch.fields())
                    if self._pin:
                        tensors = (t.pin_memory() for t in tensors)
                    batch = PaddedBatch(*tensors)
                while not self._stop.is_set():
                    try:
                        self._queue.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surface in next() instead of hanging it
            self._error = e
            while not self._stop.is_set():
                try:
                    self._queue.put(_WORKER_FAILED, timeout=0.1)
                    break
                except queue.Full:
                    continue

    # ------------------------------------------------------------------

    def next(self) -> PaddedBatch:
        """Blocking fetch of the next batch, on ``device``. Re-raises any
        exception the worker thread died on."""
        with torch.profiler.record_function("prefetch.next"):
            host = self._queue.get()
            if host is _WORKER_FAILED:
                raise RuntimeError("prefetch worker failed") from self._error
            with self._lock:
                self._in_flight -= 1
            if not self._pin:
                return host.to(self.device)
            batch = host.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record()  # on the current stream, after the copies
            self._copies.append((done, host))
            while self._copies and self._copies[0][0].query():
                self._copies.popleft()
            return batch

    def _halt_and_drain(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break

    def rewind(self, num_batches: int) -> None:
        """Rewind ``num_batches`` consumed batches plus everything the
        prefetcher pulled ahead, then resume prefetching."""
        self._halt_and_drain()
        with self._lock:
            total = num_batches + self._in_flight
            self._in_flight = 0
        for _ in range(total):
            self.dispenser.return_batch()
        self._start_worker()

    def close(self) -> None:
        self._halt_and_drain()
        while self._copies:
            done, _host = self._copies.popleft()
            done.synchronize()

    def __enter__(self) -> "PrefetchingBatchSource":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
