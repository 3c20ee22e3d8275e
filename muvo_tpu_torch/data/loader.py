"""Host-side batching and device prefetch (an own copy of
muvo_tpu/data/loader.py without JAX).

The host pipeline decodes frames (PNG/npy + range projection) in background
threads while the device computes the previous step; ``device_prefetch``
copies the batches to the card ahead of the step that takes them.

Multi-process: in a torch.distributed job every process runs the SAME
deterministic (seed, epoch) global shuffle and loads only its contiguous
slice of each global batch (process p of P takes samples [p·B/P,
(p+1)·B/P)). batch_size is always the GLOBAL batch size.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch


def _process_info():
    """(rank, world size) of an initialised torch.distributed group, else
    (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class DataLoader:
    """Minimal shuffling batch loader over a map-style dataset."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 sampler=None, seed: int = 0, drop_last: bool = True,
                 num_workers: int = 0, process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.sampler = list(sampler) if sampler is not None else None
        self.seed = seed
        self.epoch = 0
        self.drop_last = drop_last
        self.num_workers = num_workers
        pi, pc = _process_info()
        self.process_index = pi if process_index is None else process_index
        self.process_count = pc if process_count is None else process_count
        if batch_size % self.process_count:
            raise ValueError(
                f"global batch size {batch_size} not divisible by "
                f"process_count {self.process_count}")

    def __len__(self):
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        # Multi-process always drops the ragged final batch (_local_chunk:
        # uneven per-host shards can't assemble into one global array), so
        # len() must use drop-last semantics there even with drop_last=False.
        if self.drop_last or self.process_count > 1:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        """Select the deterministic shuffle for this epoch (resume support:
        same (seed, epoch) always yields the same batch order)."""
        self.epoch = int(epoch)

    def _indices(self):
        if self.sampler is not None:
            return list(self.sampler)
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx.tolist()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.iter_from(0)

    def iter_from(self, start_batch: int) -> Iterator[Dict[str, np.ndarray]]:
        """Iterate this epoch's batches, skipping the first `start_batch`
        without decoding them (preemption-safe resume mid-epoch)."""
        indices = self._indices()
        n_batches = len(self)
        if self.num_workers > 0:
            yield from self._iter_threaded(indices, n_batches, start_batch)
            return
        for b in range(start_batch, n_batches):
            chunk = self._local_chunk(indices, b)
            if chunk is None:
                break
            items = [self.dataset[i] for i in chunk]
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}

    def _local_chunk(self, indices, b):
        """This process's contiguous slice of global batch `b` (None once
        the epoch's last ragged batch is dropped). Contiguous (not strided)
        so host h's samples land on host h's devices in the process-major
        mesh device order. A ragged final batch is always dropped in
        multi-process mode (uneven per-host shards can't assemble into one
        global array)."""
        chunk = indices[b * self.batch_size:(b + 1) * self.batch_size]
        if len(chunk) < self.batch_size and (self.drop_last or
                                             self.process_count > 1):
            return None
        local = -(-len(chunk) // self.process_count)
        lo = self.process_index * local
        return chunk[lo:lo + local]

    def _iter_threaded(self, indices, n_batches, start_batch: int = 0):
        """N decode threads (PIL/ctypes release the GIL) feeding an ordered
        output queue so batch order stays deterministic.

        Backpressure is load-bearing: decoded batches are 100s of MB and
        the threads outpace a device-bound consumer, so at most
        ``2*n_workers + 2`` decoded batches may be in flight (decoding or
        parked in ``results``) — without the semaphore the results dict
        grows with the decode/consume rate gap (the r4 health-run train
        job's host RSS reached 122 GB after ~1600 steps and the kernel
        OOM-killed it). The semaphore is acquired before a decode starts
        and released when the consumer pops the batch. An abandoned
        iterator (e.g. an eval capped at max_batches) sets ``stop`` in its
        ``finally`` so the workers exit instead of decoding the rest of
        the epoch into memory."""
        n_workers = max(1, self.num_workers)
        task_q: "queue.Queue" = queue.Queue()
        results: dict = {}
        results_lock = threading.Lock()
        results_ready = threading.Condition(results_lock)
        max_ahead = 2 * n_workers + 2
        inflight = threading.Semaphore(max_ahead)
        stop = threading.Event()

        batches = []
        for b in range(start_batch, n_batches):
            chunk = self._local_chunk(indices, b)
            if chunk is None:
                break
            batches.append((len(batches), chunk))  # consumer keys are 0-based
        for item in batches:
            task_q.put(item)
        for _ in range(n_workers):
            task_q.put(None)

        def worker():
            while True:
                task = task_q.get()
                if task is None:
                    break
                b, chunk = task
                while not inflight.acquire(timeout=1.0):
                    if stop.is_set():
                        return
                if stop.is_set():
                    return
                try:
                    items = [self.dataset[i] for i in chunk]
                    batch = {k: np.stack([it[k] for it in items])
                             for k in items[0]}
                except Exception as e:  # surface errors to the consumer
                    batch = e
                with results_ready:
                    results[b] = batch
                    results_ready.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(n_workers)]
        for t in threads:
            t.start()

        try:
            for b in range(len(batches)):
                with results_ready:
                    while b not in results:
                        results_ready.wait()
                    batch = results.pop(b)
                inflight.release()
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()


def device_prefetch(iterator, device, size: int = 2):
    """Batches of ``iterator`` on ``device``, ``size`` batches ahead of the
    consumer.

    On the card each array is pinned and copied with ``non_blocking=True``,
    here on the consumer's thread (the loader's decode threads never touch
    CUDA). The host's part, the pinning and the queueing of the next
    batches, overlaps the current step; the copies themselves go on the
    current stream, so on the device they run after the kernels queued
    before them. On the CPU the batches pass through as they are: the
    trainer reads numpy arrays without a copy. The choice follows the
    device's type."""
    device = torch.device(device)
    if device.type != "cuda":
        yield from iterator
        return
    buf = []
    for batch in iterator:
        buf.append({k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                    .to(device, non_blocking=True)
                    for k, v in batch.items()})
        if len(buf) >= size:
            yield buf.pop(0)
    while buf:
        yield buf.pop(0)
