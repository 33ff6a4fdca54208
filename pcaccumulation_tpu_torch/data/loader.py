"""Batched data loader over static-shape samples (the port's copy of the
JAX package's `data/loader.py`): every sample is already padded to the
static capacities, so collation is a plain stack.

The batches, `drop_last` and the seeded shuffle order are the JAX
package's, so one seed gives both packages the same batches. In a run of
several processes (`process_id`, `process_count`) every process shuffles
with the same seed and takes the batches `process_id::process_count`,
trimmed to one length on every process, as the JAX package's loader does:
`len()` is per process. On a (data, frame, spatial) mesh
(`parallel/mesh.py`) the slice is that of the process's data coordinate
(`process_id` = the coordinate, `process_count` = the data axis's size), so
the processes of one sequence read the same samples. With
`num_workers > 0` the next batches are prepared while the caller runs the
current one, and batches still come in order:
- `mode="thread"`: a pool of threads;
- `mode="process"`: forked worker processes (the JAX package's
  `_iter_process`): worker i prepares batches[i::W] into its own bounded
  queue and the consumer takes the queues in turn. A worker's exception
  reaches the consumer with its traceback; a worker that dies without one
  is found by polling its liveness. Workers run numpy only and return
  numpy: they never touch CUDA, whose context a forked child cannot use
  (the caller pins and copies to the card as in thread mode). On the
  native preparation path (`data/voxelizer.py`) the parent loads the host
  library before it forks, so the workers inherit it and never build it.
"""

from __future__ import annotations

import collections
import multiprocessing
import queue
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from pcaccumulation_tpu_torch.data import voxelizer
from pcaccumulation_tpu_torch.native import host


def collate(samples: list[dict]) -> dict:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class _WorkerFailure:
    """A worker process's exception as text (an exception object may not
    survive pickling)."""

    def __init__(self, repr_: str, tb: str):
        self.repr = repr_
        self.tb = tb


def _process_worker(load, batch_list, out_q) -> None:
    """Worker-process body: each index batch loaded into out_q, or one
    terminal _WorkerFailure (a worker killed outright is found by the
    consumer's liveness poll)."""
    try:
        for b in batch_list:
            out_q.put(load(b))
    except Exception as e:  # raised again in the consumer
        out_q.put(_WorkerFailure(repr(e), traceback.format_exc()))


class make_loader:
    """Iterable over shuffled, collated batches.

    dataset: indexable, returns padded sample dicts; batch_size: samples
    per batch; shuffle: reshuffle the indices every epoch; num_workers:
    prefetch workers (0 = synchronous); drop_last: drop the trailing
    partial batch; seed: shuffle seed; mode: "thread" or "process" (see
    the module docstring; unused when num_workers is 0); process_id,
    process_count: this process's slice of the batches.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 2, drop_last: bool = True, seed: int = 0,
                 mode: str = "thread", process_id: int = 0, process_count: int = 1):
        if mode not in ("thread", "process"):
            raise ValueError(f"mode must be 'thread' or 'process', got {mode!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.mode = mode
        self.rng = np.random.default_rng(seed)
        self.process_id = process_id
        self.process_count = process_count

    def _n_batches(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __len__(self):
        return self._n_batches() // self.process_count

    def _index_batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(self._n_batches())]
        return batches[self.process_id::self.process_count][:len(self)]

    def _load(self, b) -> dict:
        return collate([self.dataset[int(i)] for i in b])

    def __iter__(self):
        batches = self._index_batches()
        if self.num_workers <= 0:
            for b in batches:
                yield self._load(b)
        elif self.mode == "process":
            yield from self._iter_process(batches)
        else:
            yield from self._iter_thread(batches)

    def _iter_thread(self, batches):
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

    def _iter_process(self, batches):
        """Batch j sits at place j // W of worker j % W's queue, so taking
        the queues in turn gives the original order."""
        if not batches:
            return
        w = min(self.num_workers, len(batches))
        if voxelizer._USE_NATIVE:
            host.get_lib()  # raises here if it cannot be built
        # fork: the workers inherit the dataset and the loaded host library
        ctx = multiprocessing.get_context("fork")
        procs, qs = [], []
        for i in range(w):
            q = ctx.Queue(maxsize=2)  # bounds the host memory held ahead
            p = ctx.Process(target=_process_worker, args=(self._load, batches[i::w], q),
                            daemon=True)
            p.start()
            procs.append(p)
            qs.append(q)
        try:
            for j in range(len(batches)):
                i = j % w
                while True:
                    try:
                        item = qs[i].get(timeout=1.0)
                        break
                    except queue.Empty:
                        if procs[i].is_alive():
                            continue
                        try:  # it may have put its last item just before it exited
                            item = qs[i].get(timeout=1.0)
                            break
                        except queue.Empty:
                            raise RuntimeError(
                                f"data loader worker {i} died (exit code {procs[i].exitcode}) "
                                "without reporting an error") from None
                if isinstance(item, _WorkerFailure):
                    raise RuntimeError(f"data loader worker failed: {item.repr}\n{item.tb}")
                yield item
        finally:
            for p in procs:
                p.terminate()
            for p in procs:
                p.join(timeout=5)
            for q in qs:
                q.close()
                q.cancel_join_thread()
