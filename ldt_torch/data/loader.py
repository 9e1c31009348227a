"""Shuffling batch loader with a prefetch thread, counterpart of
`ldt_tpu/data/loader.py`: the same shuffle (numpy RandomState(seed), one
permutation per epoch), the same batches (dicts of stacked numpy arrays),
and one background thread that assembles the next batches while the device
computes.

`num_workers` > 0 fetches each batch's items through a pool of that many
threads (for datasets whose items are read from disk one by one, the
non-preload ViPC loader's); the items keep their order, but draws a dataset
makes from a shared generator (ViPC's random view) then follow thread
timing.

A loop that stops early (`next(iter(loader))` to take a first batch) closes
its iterator, which lets the thread finish the batches it would have
prefetched anyway (up to `prefetch` + 1 past the last one taken, as the JAX
loader's abandoned thread does) and then joins it: the dataset's random
draws, and so every later batch, do not depend on thread timing.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator

import numpy as np


def default_collate(items):
    """Stack a list of per-example dicts into one dict of arrays."""
    out: Dict[str, Any] = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        first = vals[0]
        if isinstance(first, np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(first, (int, np.integer)):
            out[key] = np.asarray(vals, np.int32)
        elif isinstance(first, (float, np.floating)):
            out[key] = np.asarray(vals, np.float32)
        else:
            out[key] = vals  # strings etc.
    return out


class DataLoader:
    """Batches over a map-style dataset (len + __getitem__): shuffled with
    `seed` when `shuffle`, the last partial batch dropped when
    `drop_last`."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, prefetch: int = 2,
                 num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.num_workers = int(num_workers or 0)
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        end = (n // self.batch_size) * self.batch_size if self.drop_last else n
        return [order[start:min(start + self.batch_size, end)]
                for start in range(0, end, self.batch_size)]

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        batches = self._index_batches()
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error: list = []
        stop = threading.Event()
        made = [0]  # batches collated so far
        progress = threading.Condition()

        pool = (ThreadPoolExecutor(self.num_workers,
                                   thread_name_prefix="ldt-loader-item")
                if self.num_workers > 0 else None)

        def fetch(idxs):
            items = [int(i) for i in idxs]
            if pool is not None:
                return list(pool.map(self.dataset.__getitem__, items))
            return [self.dataset[i] for i in items]

        def producer():
            try:
                for idxs in batches:
                    if stop.is_set():
                        break
                    batch = default_collate(fetch(idxs))
                    with progress:
                        made[0] += 1
                        progress.notify_all()
                    q.put(batch)
            except BaseException as e:  # re-raised on the consumer side
                error.append(e)
            finally:
                with progress:
                    made[0] = len(batches)  # nothing more will be made
                    progress.notify_all()
                q.put(sentinel)

        thread = threading.Thread(target=producer, daemon=True,
                                  name="ldt-loader")
        thread.start()
        taken = 0
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                taken += 1
                yield item
        finally:
            # closed early: let the thread make what it would have
            # prefetched, then stop it and drain the queue so it can exit
            target = min(len(batches), taken + self.prefetch + 1)
            with progress:
                progress.wait_for(lambda: made[0] >= target)
            stop.set()
            while thread.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            thread.join()
            if pool is not None:
                pool.shutdown()
        if error:
            # a swallowed producer exception would end the epoch early with
            # no error: the loop would train on part of the data
            raise error[0]
