"""Threaded, prefetching host data pipeline (counterpart of
ips_tpu/data/loader.py).

A thread pool materializes samples (numpy releases the GIL for the heavy
densify/patchify work) and a bounded queue keeps ``prefetch`` batches
ready. It is not ``torch.utils.data.DataLoader``: the batch order comes
from numpy's ``default_rng(seed)`` drawn exactly as the JAX package's
loader draws it, so one seed gives both packages the same batches.
A dataset that augments each item (traffic) gets the item's draw from
its place in the epoch's global order (``DataLoader``'s draw rule), so
threads and data ranks load the batches of one process without threads.
Pinned memory and the copy to the card are the training loop's
(``ips_tpu_torch.train.loop``).
"""

from __future__ import annotations

import queue
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


class Dataset:
    """Minimal dataset protocol: __len__ + __getitem__ -> dict[str, ndarray]."""

    def __len__(self) -> int:  # pragma: no cover - interface
        raise NotImplementedError

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:  # pragma: no cover
        raise NotImplementedError


def _collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([np.asarray(s[k]) for s in samples], axis=0)
            for k in samples[0]}


class DataLoader:
    """Shuffling, batching, prefetching iterator over a Dataset; batches
    are dicts of stacked numpy arrays.

    The draw rule. A dataset that augments each item from a draw keeps
    the draw counter itself (``take_draws(n)`` returns the first of n
    draws and moves it on, so a loader built later over the dataset goes
    on where the last one stopped) and fetches with ``item(i, draw)``.
    The one thread that walks an epoch's global batches (after the
    shuffle and any buckets, before a data rank's slice) reserves
    ``len(batch)`` draws for each batch as it comes up, and global row r
    takes draw ``base + r``: an item's draw is its place in the epoch's
    global order, the order in which one process without threads
    fetches. A data rank keeps its rows with their draws, and the threads
    fetch (index, draw) pairs; so any thread count and any data rank
    load rows of one process's batches, bitwise. ``skip_epochs`` skips
    the draws of whole global epochs. That thread is the consumer without
    threads and the producer with them, which may reserve the draws of
    up to ``prefetch + 1`` batches that an epoch left unread never
    yields. A dataset without ``take_draws`` is fetched by ``dataset[i]``.
    """

    def __init__(self, dataset: Dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 0, drop_last: bool = False,
                 prefetch: int = 2, seed: int = 0,
                 collate_fn=None, process_index: int = 0,
                 process_count: int = 1, bucket_fn=None):
        """bucket_fn(i) -> hashable: when given, every batch holds samples
        of one bucket only (e.g. one padded shape), so variable-N datasets
        can batch more than one row. Within-bucket order and the order of
        batches are both shuffled when shuffle=True.

        process_index/process_count: data rank ``process_index`` of
        ``process_count`` loads only its contiguous batch_size /
        process_count rows of each global batch; every rank draws the same
        global order from ``seed``, and the ragged last batch is dropped so
        that all ranks agree on shapes.
        """
        if process_count > 1 and batch_size % process_count:
            raise ValueError(
                f"batch_size={batch_size} must be divisible by "
                f"process_count={process_count}")
        if not (0 <= process_index < max(process_count, 1)):
            raise ValueError(
                f"process_index={process_index} out of range for "
                f"process_count={process_count}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(0, num_workers)
        self.drop_last = drop_last or process_count > 1
        self.prefetch = max(1, prefetch)
        self.collate_fn = collate_fn or _collate
        self.process_index = process_index
        self.process_count = max(1, process_count)
        self.bucket_fn = bucket_fn
        self._rng = np.random.default_rng(seed)
        if bucket_fn is not None:
            self._bucket_groups = {}
            for i in range(len(dataset)):
                self._bucket_groups.setdefault(bucket_fn(i), []).append(i)
            if self.drop_last:
                # fixed bucket membership: drop_last loses the same samples
                # every epoch, unlike the unbucketed ragged tail
                lost = sum(len(g) % self.batch_size
                           for g in self._bucket_groups.values())
                if lost:
                    print(f"warning: bucket-batched loader with drop_last "
                          f"permanently excludes {lost} samples in "
                          f"partial per-bucket batches", file=sys.stderr)

    def _n_batches(self, n: int) -> int:
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __len__(self) -> int:
        if self.bucket_fn is not None:
            return sum(self._n_batches(len(g))
                       for g in self._bucket_groups.values())
        return self._n_batches(len(self.dataset))

    def _global_batches(self) -> List[np.ndarray]:
        """One epoch's batches of all ranks, in order (draws the epoch's
        shuffle)."""
        if self.bucket_fn is not None:
            batches = []
            for key in sorted(self._bucket_groups):
                g = np.asarray(self._bucket_groups[key])
                if self.shuffle:
                    self._rng.shuffle(g)
                batches.extend(
                    g[j * self.batch_size:(j + 1) * self.batch_size]
                    for j in range(self._n_batches(len(g))))
            if self.shuffle:
                self._rng.shuffle(batches)
            return batches
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        return [idx[i * self.batch_size:(i + 1) * self.batch_size]
                for i in range(len(self))]

    def _rows(self) -> slice:
        """This rank's rows of a global batch."""
        k = self.batch_size // self.process_count
        return slice(self.process_index * k, (self.process_index + 1) * k)

    def _batch_indices(self) -> List[np.ndarray]:
        """One epoch's batches of this rank (draws the epoch's shuffle)."""
        return [b[self._rows()] for b in self._global_batches()]

    def skip_epochs(self, k: int) -> None:
        """Advance the shuffle stream past ``k`` epochs without loading
        data, so that a run resumed at epoch k sees the batch order an
        unbroken run saw there. A dataset that draws per item (a
        ``skip_draws(n)`` method) skips the draws of those epochs' global
        batches too, on every rank."""
        n_items = 0
        for _ in range(max(0, k)):
            n_items += sum(len(b) for b in self._global_batches())
        skip = getattr(self.dataset, "skip_draws", None)
        if skip is not None and n_items:
            skip(n_items)

    def _fetches(self, batches: List[np.ndarray]) -> Iterator[list]:
        """Per global batch, this rank's fetches: indices, or (index,
        draw) pairs whose draws are reserved as the batch comes up."""
        take = getattr(self.dataset, "take_draws", None)
        rows = self._rows()
        for b in batches:
            if take is None:
                yield [int(i) for i in b[rows]]
            else:
                base = take(len(b)) + rows.start
                yield [(int(i), base + r) for r, i in enumerate(b[rows])]

    def _fetch(self, job):
        if isinstance(job, tuple):
            return self.dataset.item(*job)
        return self.dataset[job]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        fetches = self._fetches(self._global_batches())
        if self.num_workers == 0:
            for jobs in fetches:
                yield self.collate_fn([self._fetch(j) for j in jobs])
            return
        yield from self._iter_threaded(fetches)

    def _iter_threaded(self, fetches: Iterator[list]):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error: List[Optional[BaseException]] = [None]
        stop = threading.Event()

        def put(item) -> bool:
            # bounded put that notices an abandoned consumer, also when
            # the consumer's drain below made the room for it
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return not stop.is_set()
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for jobs in fetches:
                        samples = list(pool.map(self._fetch, jobs))
                        if not put(self.collate_fn(samples)):
                            return
            except BaseException as e:  # noqa: BLE001 - re-raised below
                error[0] = e
            finally:
                put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
            t.join()
            if error[0] is not None:
                raise error[0]
        finally:
            # consumer broke out / raised: unblock and stop the producer
            stop.set()
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
