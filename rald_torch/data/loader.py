"""Sharded sampling + batched, prefetching data loading: the port's own copy
of ``rald_tpu/data/loader.py``, kept on its design (not
``torch.utils.data``) so that a batch of the port equals the JAX package's
batch element for element.

- :class:`ShardedSampler` reproduces DistributedSampler semantics: seeded
  per-epoch shuffle, padding with duplicated entries so every data-parallel
  process sees the same number of samples, optional drop_last;
- :class:`DataLoader` fetches items on a thread pool (numpy I/O releases the
  GIL), collates numpy dicts into stacked batches, and keeps a bounded
  prefetch queue so host work overlaps device steps.

Device placement is the engine's job. A consumer that stops early (breaks
out of the loop, raises, or drops the iterator) stops the producer thread
too: it gives up its pending ``put`` and the thread pool shuts down.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


class ShardedSampler:
    """Per-process view of a globally shuffled index sequence."""

    def __init__(
        self,
        dataset_len: int,
        num_replicas: int = 1,
        rank: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ):
        assert 0 <= rank < num_replicas
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        if drop_last:
            self.num_samples = dataset_len // num_replicas
        else:
            self.num_samples = -(-dataset_len // num_replicas)

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def __len__(self):
        return self.num_samples

    def __iter__(self):
        if self.shuffle:
            rng = np.random.default_rng([self.seed, self.epoch])
            indices = rng.permutation(self.dataset_len)
        else:
            indices = np.arange(self.dataset_len)
        total = self.num_samples * self.num_replicas
        if self.drop_last:
            indices = indices[:total]
        elif total > len(indices):  # pad with duplicates (DistributedSampler behavior)
            indices = np.concatenate([indices, indices[: total - len(indices)]])
        return iter(indices[self.rank : : self.num_replicas].tolist())


def collate(items: list[dict]) -> dict:
    """Stack numpy-array values; keep non-arrays as lists.

    Arrays whose leading dim differs across items (bucket-padded ragged eval
    with batch > 1 straddling buckets) are zero-padded to the batch max —
    the max of bucket sizes is itself a bucket size, so the shape set stays
    bounded.
    """
    out = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], np.ndarray):
            if len({v.shape[0] for v in vals}) > 1 and all(
                v.shape[1:] == vals[0].shape[1:] for v in vals
            ):
                m = max(v.shape[0] for v in vals)
                vals = [
                    np.concatenate(
                        [v, np.zeros((m - v.shape[0],) + v.shape[1:], v.dtype)]
                    ) if v.shape[0] < m else v
                    for v in vals
                ]
            out[key] = np.stack(vals)
        elif isinstance(vals[0], (np.integer, np.floating, int, float)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals
    return out


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        sampler: ShardedSampler | None = None,
        num_workers: int = 4,
        drop_last: bool = True,
        prefetch: int = 2,
        pad_last: bool = False,
    ):
        """``pad_last``: fill a ragged final batch by repeating its last
        index so every batch is exactly ``batch_size``. Mirrors
        DistributedSampler's duplicate padding and its caveat (reference
        main_ae.py:64-70: "This will slightly alter validation results as
        extra duplicate entries are added")."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or ShardedSampler(len(dataset), shuffle=False)
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.pad_last = pad_last

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        self.sampler.set_epoch(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _batches(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            if self.pad_last:
                batch = batch + [batch[-1]] * (self.batch_size - len(batch))
            yield batch

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def put(item) -> bool:
            """Hand ``item`` to the consumer; False once it has gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for batch_idx in self._batches():
                        items = list(pool.map(self.dataset.__getitem__, batch_idx))
                        if not put(collate(items)):
                            return
            except BaseException as e:  # surface worker errors in the consumer
                put(e)
                return
            put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()
