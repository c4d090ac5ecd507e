"""Input pipeline: threaded prefetching loaders yielding numpy batches.

The port's own copy of ``multimodal_dataset_distillation_tpu/data/
pipeline.py``: the same batch order for the same seed and epoch, and the
same per-item augmentation RNG.  Replaces the reference's
``torch.utils.data.DataLoader`` usage (``data/__init__.py:236-256``: 4
workers, drop_last on train); a thread pool overlaps PIL decode/augment
with device compute.  Batches stay host numpy (NHWC); the trainer moves
them to its device.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np

from ..utils import augrng
from ..utils.logging import span


class Loader:
    """Iterable over (stacked_images, list_or_array_extras...) batches.

    Two ways to feed data-parallel ranks, both ``(index, count)``:

    * ``shard`` (the JAX Loader's, multi-node ``--distributed``): every
      process draws the same epoch permutation and takes its contiguous
      ``1/count`` of it (equal shards, the remainder dropped);
      ``batch_size`` is the per-process batch.
    * ``rows``: the batches of the unsharded loader, each cut to its
      ``index``-th of ``count`` equal parts (only those items are read),
      so the ranks together see the one-process batches.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 4,
                 seed: Optional[int] = None, prefetch: int = 2,
                 shard: Optional[Tuple[int, int]] = None,
                 rows: Optional[Tuple[int, int]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = prefetch
        self.shard = shard
        if rows is not None and (batch_size % rows[1] or not drop_last):
            raise ValueError(f"batches of {batch_size} cut in {rows[1]} "
                             f"parts: the batch must divide and drop_last "
                             f"be set")
        self.rows = rows
        self._epoch = 0

    def set_epoch(self, epochs_done: int) -> None:
        """Continue as a loader that has served ``epochs_done`` epochs (the
        next one shuffles with ``seed + epochs_done + 1``): an expert of a
        fan-out sees the batches of the sequential run."""
        self._epoch = int(epochs_done)

    def _shard_len(self) -> int:
        n = len(self.dataset)
        return n if self.shard is None else n // self.shard[1]

    def __len__(self) -> int:
        n = self._shard_len()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = (np.random.RandomState(self.seed + self._epoch)
                   if self.seed is not None else np.random)
            rng.shuffle(idx)
        if self.shard is not None:
            pid, nproc = self.shard
            per = len(self.dataset) // nproc
            idx = idx[pid * per:(pid + 1) * per]
        return idx

    def _collate(self, items: List[Tuple]) -> Tuple:
        cols = list(zip(*items))
        out: List[Any] = [np.stack(cols[0])]
        for col in cols[1:]:
            if isinstance(col[0], str):
                out.append(list(col))
            else:
                out.append(np.asarray(col))
        return tuple(out)

    def __iter__(self) -> Iterator[Tuple]:
        self._epoch += 1
        idx = self._indices()
        n_batches = len(self)
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(n_batches)]
        if self.rows is not None:
            part, count = self.rows
            per = self.batch_size // count
            batches = [b[part * per:(part + 1) * per] for b in batches]

        if self.seed is not None:
            # per-item augmentation RNG: a seeded loader's augment draws
            # are a pure function of (seed, epoch, dataset index),
            # deterministic under any worker-thread schedule (the global
            # np.random stream is neither thread-safe nor schedule-free)
            epoch, base = self._epoch, self.seed

            def fetch(i):
                augrng.seed_item(base, epoch, i)
                try:
                    return self.dataset[i]
                finally:
                    augrng.clear()
        else:
            fetch = self.dataset.__getitem__

        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            # per-item futures, windowed over `prefetch` batches ahead
            pending: List[List[cf.Future]] = []
            next_batch = 0

            def enqueue():
                nonlocal next_batch
                if next_batch < n_batches:
                    pending.append([pool.submit(fetch, i)
                                    for i in batches[next_batch]])
                    next_batch += 1

            for _ in range(self.prefetch + 1):
                enqueue()
            while pending:
                futs = pending.pop(0)
                enqueue()
                yield self._collate([f.result() for f in futs])


class ArrayPairLoader:
    """In-memory (images, text_embeds) loader — the reference's
    ``TensorDataset`` + DataLoader combo for synthetic-set training
    (``utils.py:109-125``, ``epoch_original.py:175-176``)."""

    def __init__(self, images: np.ndarray, texts: np.ndarray,
                 batch_size: int, shuffle: bool = True,
                 seed: Optional[int] = None):
        assert len(images) == len(texts)
        self.images = np.asarray(images)
        self.texts = np.asarray(texts)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

    def __len__(self):
        return (len(self.images) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        self._epoch += 1
        idx = np.arange(len(self.images))
        if self.shuffle:
            rng = (np.random.RandomState(self.seed + self._epoch)
                   if self.seed is not None else np.random)
            rng.shuffle(idx)
        for i in range(len(self)):
            with span("data.batch"):
                b = idx[i * self.batch_size:(i + 1) * self.batch_size]
                batch = self.images[b], self.texts[b]
            yield batch
