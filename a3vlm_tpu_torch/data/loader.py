"""Host-side batching: dataset + sampler -> stacked numpy batches for the
train step (the torch DataLoader role, main_finetune.py:310-316,
without worker processes — this host has the input pipeline overlapped with
device steps via simple double-buffered prefetch)."""

from __future__ import annotations

import threading
from queue import Queue
from typing import Iterator

import numpy as np


def _stack(items: list[dict]) -> dict:
    keys = items[0].keys()
    assert all(it.keys() == keys for it in items), "mixed batch structure"
    return {k: np.stack([it[k] for it in items]) for k in keys}


class DataLoader:
    """Yields dict batches [accum, micro_bs, ...] drawn from one sampler
    pass. With accum_steps > 1, consecutive micro-batches are grouped along
    a leading axis for the train step's accumulation scan."""

    def __init__(
        self,
        dataset,
        sampler,
        batch_size: int,
        accum_steps: int = 1,
        prefetch: int = 2,
        workers: int = 0,
        with_indices: bool = False,
    ):
        """``workers`` > 0 fetches the items of each micro-batch through a
        thread pool (the torch num_workers role at thread granularity —
        image decode and cv2/PIL transforms release the GIL, so multi-core
        hosts overlap per-item work; item ORDER inside the batch is
        preserved).

        ``with_indices`` adds a ``_indices`` key ([bs] or [accum, bs]
        int64) carrying each item's dataset index — the stable cache key
        for train/feature_cache.py."""
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.accum_steps = accum_steps
        self.prefetch = prefetch
        self.workers = workers
        self.with_indices = with_indices
        self._pool = None
        if workers > 0:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=workers)

    def close(self):
        """Release worker threads deterministically (idempotent)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()

    def _fetch(self, indices):
        if self._pool is None:
            return [self.dataset[i] for i in indices]
        return list(self._pool.map(self.dataset.__getitem__, indices))

    def __len__(self):
        return len(self.sampler) // (self.batch_size * self.accum_steps)

    def _produce(self) -> Iterator[dict]:
        indices = list(iter(self.sampler))
        step_span = self.batch_size * self.accum_steps
        for start in range(0, len(indices) - step_span + 1, step_span):
            micro = []
            for a in range(self.accum_steps):
                s = start + a * self.batch_size
                span = indices[s : s + self.batch_size]
                m = _stack(self._fetch(span))
                if self.with_indices:
                    m["_indices"] = np.asarray(span, np.int64)
                micro.append(m)
            batch = {k: np.stack([m[k] for m in micro]) for k in micro[0]}
            if self.accum_steps == 1:
                batch = {k: v[0] for k, v in batch.items()}
            yield batch

    def __iter__(self):
        if self.prefetch <= 0:
            yield from self._produce()
            return
        q: Queue = Queue(maxsize=self.prefetch)
        sentinel = object()
        error: list[BaseException] = []

        def worker():
            try:
                for b in self._produce():
                    q.put(b)
            except BaseException as e:  # propagate into the consumer
                error.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            b = q.get()
            if b is sentinel:
                if error:
                    raise error[0]
                break
            yield b
