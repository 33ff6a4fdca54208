"""Batched data loader over static-shape samples (the port's copy of the
JAX package's `data/loader.py`, one process): every sample is already
padded to the static capacities, so collation is a plain stack.

The batches, `drop_last` and the seeded shuffle order are the JAX
package's, so one seed gives both packages the same batches. With
`num_workers > 0` a pool of threads prepares the next batches while the
caller runs the current one; batches still come in order.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def collate(samples: list[dict]) -> dict:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class make_loader:
    """Iterable over shuffled, collated batches.

    dataset: indexable, returns padded sample dicts; batch_size: samples
    per batch; shuffle: reshuffle the indices every epoch; num_workers:
    prefetch threads (0 = synchronous); drop_last: drop the trailing
    partial batch; seed: shuffle seed.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 2, drop_last: bool = True, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _index_batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        return [idx[i * self.batch_size:(i + 1) * self.batch_size] for i in range(len(self))]

    def _load(self, b) -> dict:
        return collate([self.dataset[int(i)] for i in b])

    def __iter__(self):
        batches = self._index_batches()
        if self.num_workers <= 0:
            for b in batches:
                yield self._load(b)
            return
        with ThreadPoolExecutor(self.num_workers) as pool:
            ahead = collections.deque()
            todo = iter(batches)
            for b in todo:
                ahead.append(pool.submit(self._load, b))
                if len(ahead) >= 2 * self.num_workers:
                    break
            while ahead:
                batch = ahead.popleft().result()
                nxt = next(todo, None)
                if nxt is not None:
                    ahead.append(pool.submit(self._load, nxt))
                yield batch
