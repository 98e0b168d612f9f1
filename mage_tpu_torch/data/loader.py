"""A lightweight batching loader over map-style datasets.

The port's copy of ``mage_tpu/data/loader.py``, with the same epoch order:
a ``RandomState(seed + epoch)`` permutation, and with several processes a
disjoint contiguous shard of it per process (the DistributedSampler
equivalent, reference main_mage.py:108-119). Items are numpy, as the
datasets make them; ``default_collate`` stacks them into CPU
``torch.Tensor``s, which the trainers move to their device.
``PrefetchLoader`` re-raises in the consumer whatever its worker thread
raised, so a failing item fails the epoch instead of ending it early.
"""

from __future__ import annotations

from typing import Any, Iterator

import numpy as np
import torch

# batches the prefetch thread may hold ready ahead of the consumer
PREFETCH_DEPTH = 2


class Loader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        num_shards: int = 1,
        shard_index: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle deterministically per epoch (the reference's
        ``sampler.set_epoch``, main_mage.py:138-139)."""
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.RandomState(self.seed + self.epoch).permutation(n)
        else:
            order = np.arange(n)
        if self.num_shards > 1:
            per = n // self.num_shards
            order = order[self.shard_index * per : (self.shard_index + 1) * per]
        return order

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Any]:
        order = self._indices()
        for start in range(0, len(order), self.batch_size):
            chunk = order[start : start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield default_collate([self.dataset[int(i)] for i in chunk])


class PrefetchLoader:
    """Background-thread prefetching around a Loader: overlaps host-side
    decode/collate with device compute (device steps release the GIL).
    Single-threaded equivalent of the reference's ``num_workers=4``
    DataLoader (main_mage.py:114-119). An exception in the worker is
    raised again in the consumer after the batches before it."""

    def __init__(self, loader: "Loader"):
        self.loader = loader

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH_DEPTH)
        sentinel = object()
        failure: list = []
        stop = threading.Event()

        def worker():
            try:
                for batch in self.loader:
                    if stop.is_set():
                        return
                    q.put(batch)
            except BaseException as e:  # raised again in the consumer below
                failure.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while (item := q.get()) is not sentinel:
                yield item
        finally:
            # a consumer that stops early: unblock the worker and wait for it
            stop.set()
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.01)
        if failure:
            raise failure[0]


def default_collate(items: list) -> Any:
    """Dicts per key, strings as lists, everything else as one CPU tensor
    stacked from the items' numpy arrays (their dtypes kept)."""
    first = items[0]
    if isinstance(first, dict):
        return {k: default_collate([d[k] for d in items]) for k in first}
    if isinstance(first, (str, bytes)):
        return list(items)
    arrs = [np.asarray(x) for x in items]
    return torch.from_numpy(np.stack(arrs))
