"""Threaded prefetching batch loader; a copy of ``univtg_tpu/data/loader.py``
(its per-rank shards and its multi-process bucket plan, ``plan_shards``,
included).

Replaces torch DataLoader worker processes with a thread pool (feature IO is
numpy/npz -- it releases the GIL in zlib/blas) plus an N-deep prefetch queue
so host assembly overlaps device compute.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np

from univtg_tpu_torch.core.padding import bucket_length


class Loader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_fn: Callable,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        num_threads: int = 8,
        prefetch: int = 4,
        pad_partial: bool = True,
        shard_index: int = 0,
        num_shards: int = 1,
        lengths=None,
        bucket_window: int = 8,
        plan_shards: bool = False,
        plan_buckets=None,
        plan_margin: int = 8,
    ):
        """lengths: optional per-item length estimates (e.g.
        MRDataset.feature_lengths()). When given with shuffle=True, shuffled
        indices are length-sorted inside windows of bucket_window*batch_size
        so each batch's max length -- and therefore its collate bucket --
        tracks the local length distribution; batch ORDER is re-shuffled so
        no length curriculum leaks into SGD."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.pad_partial = pad_partial
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.lengths = None if lengths is None else np.asarray(lengths)
        self.bucket_window = bucket_window
        # Multi-process bucket plan (plan_shards=True): every rank computes
        # the same global batch list (shuffle -> window sort -> global
        # batches of batch_size*num_shards, partial dropped, order
        # re-shuffled) from the shared metadata lengths, takes its strided
        # slice of each global batch, and pads to the same per-batch bucket
        # hint, so the ranks' shapes cannot diverge. The hint adds
        # plan_margin clips of safety because `lengths` are estimates.
        self.plan_shards = plan_shards
        self.plan_buckets = None if plan_buckets is None else list(plan_buckets)
        self.plan_margin = plan_margin
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _window_sort(self, idx, effective_bs: int):
        """Window-local length sort: same population, locally homogeneous
        batch lengths (bounded bucket padding). Shared by the per-shard and
        global-plan paths."""
        w = max(effective_bs, effective_bs * self.bucket_window)
        chunks = [idx[i : i + w] for i in range(0, len(idx), w)]
        return np.concatenate(
            [c[np.argsort(self.lengths[c], kind="stable")] for c in chunks]
        )

    def _indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            rng.shuffle(idx)
        # per-host contiguous shard (replaces DistributedSampler,
        # SURVEY.md 2.8): equal shard sizes by dropping the remainder
        if self.num_shards > 1:
            per = len(idx) // self.num_shards
            idx = idx[self.shard_index * per : (self.shard_index + 1) * per]
        if self.lengths is not None and self.shuffle:
            idx = self._window_sort(idx, self.batch_size)
        return idx

    def _planning(self) -> bool:
        return (
            self.plan_shards
            and self.num_shards > 1
            and self.lengths is not None
            and self.shuffle
        )

    def _global_plan(self):
        """(global batches, pad hints), the same on every rank for a given
        (seed, epoch)."""
        idx = np.arange(len(self.dataset))
        np.random.default_rng((self.seed, self.epoch)).shuffle(idx)
        gbs = self.batch_size * self.num_shards
        idx = self._window_sort(idx, gbs)
        batches = [idx[i : i + gbs] for i in range(0, len(idx), gbs)]
        batches = [b for b in batches if len(b) == gbs]  # equal steps/rank
        np.random.default_rng((self.seed, self.epoch, 1)).shuffle(batches)
        ladder = (self.plan_buckets or []) + [1 << 30]
        hints = [
            bucket_length(
                int(self.lengths[b].max()) + self.plan_margin, sorted(set(ladder))
            )
            for b in batches
        ]
        return batches, hints

    def __len__(self):
        if self._planning():
            # full global batches only (remainder dropped)
            return len(self.dataset) // (self.batch_size * self.num_shards)
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        if self._planning():
            gb, hints = self._global_plan()
            batches = [b[self.shard_index :: self.num_shards] for b in gb]
        else:
            hints = None
            indices = self._indices()
            batches = [
                indices[i : i + self.batch_size]
                for i in range(0, len(indices), self.batch_size)
            ]
            if self.drop_last:
                batches = [b for b in batches if len(b) == self.batch_size]
            if self.lengths is not None and self.shuffle:
                # de-correlate batch order from length order (no curriculum)
                np.random.default_rng((self.seed, self.epoch, 1)).shuffle(batches)

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            # always terminate the stream: a sentinel on success, the
            # exception itself on failure (re-raised on the consumer side --
            # a bare thread death would deadlock the consumer)
            try:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    for bi, batch_idx in enumerate(batches):
                        if stop.is_set():
                            return
                        items = list(pool.map(self.dataset.__getitem__, batch_idx))
                        pad_to = self.batch_size if self.pad_partial else None
                        kw = {} if hints is None else {"pad_v_to": hints[bi]}
                        q.put(self.collate_fn(items, pad_batch_to=pad_to, **kw))
            except BaseException as exc:  # noqa: BLE001
                q.put(exc)
                return
            q.put(None)

        worker = threading.Thread(target=produce, daemon=True)
        worker.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            # drain so the producer is never blocked on a full queue
            while not q.empty():
                q.get_nowait()
