"""Threaded batch loader (copy of mafed_tpu/data/loader.py).

Items are loaded on a thread pool (image decode in PIL's C core releases
the GIL) and collated batches queue ahead of the consumer. The epoch order
is a numpy Generator's shuffle seeded with seed + epoch, so it is the same
in both packages. Device transfer is data/prefetch.py's.

Data parallelism (core/dist.py): with shard_id / num_shards every rank
walks the same seeded order and loads its interleaved slice,
order[shard_id::num_shards], so that batch i of every rank together hold
the rows of batch i of one process at num_shards times the batch size (the
replacement of the reference's DistributedSampler, replay.py:46-49). With
drop_last, the order is first cut to a multiple of num_shards * batch_size,
so every rank takes as many steps.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List

import numpy as np


class BatchLoader:
    """Iterable over collated batches, made by background workers."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        collate: Callable[[List[Dict]], Dict],
        shuffle: bool = False,
        seed: int = 0,
        num_workers: int = 4,
        drop_last: bool = False,
        prefetch_batches: int = 4,
        infinite: bool = False,
        shard_id: int = 0,
        num_shards: int = 1,
    ) -> None:
        """infinite: an endless stream of full batches, batch_size-chunks of
        the concatenated epoch orders (each epoch's remainder carries into
        the next, so a dataset smaller than a batch still fills batches).
        shard_id / num_shards: the rank's slice of each epoch's order."""
        num_shards = max(1, num_shards)
        if infinite and len(dataset) < num_shards:
            raise ValueError(f"an infinite BatchLoader needs at least {num_shards} samples (one a shard); "
                             f"the dataset has {len(dataset)}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch_batches = prefetch_batches
        self.infinite = infinite
        self.shard_id = shard_id
        self.num_shards = num_shards
        self._epoch = 0
        self._start_batch = 0
        self._start_index = 0  # infinite streams: the offset into the first epoch's order

    def set_epoch(self, epoch: int, start_batch: int = 0) -> None:
        """The epoch whose seeded order the next iteration walks, skipping its
        first start_batch batches (at the index level: nothing is loaded for
        them)."""
        self._epoch = epoch
        self._start_batch = start_batch
        self._start_index = 0

    def set_draws(self, n_draws: int) -> None:
        """Start an infinite stream just past its first n_draws batches (the
        memory stream of a resumed task). The stream is batch_size-chunks of
        the concatenated per-shard epoch orders, so draw n starts at flat
        index n * batch_size."""
        if not self.infinite:
            raise ValueError("set_draws positions infinite streams; use set_epoch")
        flat = n_draws * self.batch_size
        self._epoch, self._start_index = divmod(flat, len(self.dataset) // self.num_shards)
        self._start_batch = 0

    def _epoch_order(self, epoch: int) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        return order

    def _shard_order(self, epoch: int) -> np.ndarray:
        """One epoch of the infinite stream's order on this shard: the seeded
        order cut to a multiple of num_shards, then the shard's slice."""
        order = self._epoch_order(epoch)
        if self.num_shards > 1:
            order = order[: len(order) - len(order) % self.num_shards][self.shard_id :: self.num_shards]
        return order

    def _index_batches(self, epoch: int) -> List[np.ndarray]:
        order = self._epoch_order(epoch)
        if self.num_shards > 1:
            if self.drop_last:  # every shard takes as many batches
                order = order[: len(order) - len(order) % (self.num_shards * self.batch_size)]
            order = order[self.shard_id :: self.num_shards]
        batches = []
        for start in range(0, len(order), self.batch_size):
            idx = order[start : start + self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                continue
            batches.append(idx)
        return batches

    def _infinite_batches(self, stop: threading.Event) -> Iterator[np.ndarray]:
        epoch, start, buf = self._epoch, self._start_index, np.empty((0,), dtype=np.int64)
        while not stop.is_set():
            buf = np.concatenate([buf, self._shard_order(epoch)[start:]])
            epoch, start = epoch + 1, 0
            while len(buf) >= self.batch_size:
                idx, buf = buf[: self.batch_size], buf[self.batch_size :]
                yield idx

    def __len__(self) -> int:
        n = len(self.dataset) // self.num_shards if self.num_shards > 1 else len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict]:
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()
        error: List[BaseException] = []
        if self.infinite:
            index_batches = self._infinite_batches(stop)
        else:
            index_batches = iter(self._index_batches(self._epoch)[self._start_batch :])

        def produce():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for idx in index_batches:
                        if stop.is_set():
                            return
                        items = list(pool.map(self.dataset.__getitem__, idx))
                        out_q.put(self.collate(items))
            except BaseException as exc:  # handed to the consumer, which raises it:
                # a swallowed collate error (the label_tail guard) would end the epoch early
                error.append(exc)
            finally:
                out_q.put(None)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    if error:
                        raise error[0]
                    break
                yield batch
        finally:
            stop.set()
            while True:  # drain so the producer can exit
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break
