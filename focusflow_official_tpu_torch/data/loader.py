"""Threaded prefetching batch loader (the host side of the input
pipeline).

Worker threads read and augment samples on the CPU while the card runs the
previous step; batches are stacked NHWC numpy arrays. The epoch order is a
seeded shuffle (`np.random.RandomState(seed + epoch)`), a dataset smaller
than a batch is cycled to fill one, and `batches(start_step=...)` resumes
the stream at a step; a sample that fails to load raises in the consumer.
Batches of mixed resolutions are zero-padded to the
largest and carry the true per-sample `sizes`. Sharding over processes is
by index stride (`process_index::process_count`); the per-process batch is
`global_batch // process_count`. The same loader as the JAX package's
(`data/loader.py`), batch for batch.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

_STACK_KEYS = ("image1", "image2", "flow", "mask1", "mask2", "valid")
_PAD_KEYS = frozenset(_STACK_KEYS)


class Loader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 4,
        drop_last: bool = True,
        process_index: int = 0,
        process_count: int = 1,
        prefetch: int = 4,
    ):
        if batch_size % process_count:
            raise ValueError(f"batch size {batch_size} is not a multiple of "
                             f"{process_count} processes")
        self.dataset = dataset
        self.global_batch = batch_size
        self.local_batch = batch_size // process_count
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch

    def __len__(self):
        n = len(self.dataset) // self.global_batch
        if not self.drop_last and len(self.dataset) % self.global_batch:
            n += 1
        return n

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + epoch)
            rng.shuffle(idx)
        if n < self.global_batch:  # tiny dataset: cycle it to fill one batch
            idx = np.tile(idx, -(-self.global_batch // n))
        return idx

    def _collate(self, samples) -> Dict[str, np.ndarray]:
        out = {}
        # raw batches of mixed datasets carry several resolutions: every
        # spatial array zero-padded to the batch's largest, with the true
        # per-sample `sizes`
        hs = [int(s["image1"].shape[0]) for s in samples]
        ws = [int(s["image1"].shape[1]) for s in samples]
        hetero = len(set(hs)) > 1 or len(set(ws)) > 1
        mh, mw = max(hs), max(ws)
        for k in _STACK_KEYS:
            if k in samples[0]:
                arrs = [s[k] for s in samples]
                if hetero and k in _PAD_KEYS:
                    arrs = [np.pad(a, [(0, mh - a.shape[0]), (0, mw - a.shape[1])]
                                   + [(0, 0)] * (a.ndim - 2)) for a in arrs]
                out[k] = np.stack(arrs, axis=0)
        if "recipe" in samples[0]:
            out["recipe"] = np.asarray([s["recipe"] for s in samples], np.int32)
            out["sizes"] = np.asarray(list(zip(hs, ws)), np.int32)
        return out

    def batches(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite batch stream; restartable at `start_step` for resume."""
        work_q: queue.Queue = queue.Queue(maxsize=self.prefetch * self.local_batch)
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)

        def producer():
            epoch = 0
            step = 0
            while True:
                idx = self._epoch_indices(epoch)
                usable = (len(idx) // self.global_batch) * self.global_batch
                for b0 in range(0, usable, self.global_batch):
                    if step < start_step:
                        step += 1
                        continue
                    rows = idx[b0 : b0 + self.global_batch]
                    local = rows[self.process_index :: self.process_count]
                    work_q.put((step, list(local)))
                    step += 1
                epoch += 1

        def worker():
            while True:
                step, rows = work_q.get()
                try:
                    batch = self._collate([self.dataset[int(i)] for i in rows])
                except Exception as e:  # noqa: BLE001 - raised in the consumer
                    batch = e
                out_q.put((step, batch))

        threading.Thread(target=producer, daemon=True).start()
        for _ in range(self.num_workers):
            threading.Thread(target=worker, daemon=True).start()

        # re-order by step so the stream is deterministic despite threading
        pending = {}
        next_step = start_step
        while True:
            while next_step not in pending:
                step, batch = out_q.get()
                pending[step] = batch
            batch = pending.pop(next_step)
            if isinstance(batch, Exception):
                raise RuntimeError(f"loading the batch of step {next_step} failed") from batch
            yield batch
            next_step += 1
