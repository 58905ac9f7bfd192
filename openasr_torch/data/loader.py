"""Prefetching data loader: sampler + collate -> background-threaded batches.

Counterpart of openasr_tpu/data/loader.py (single host).  Ark reads are
IO-bound NumPy work, so a thread pool with a bounded prefetch queue
suffices; batches come out as NumPy dicts.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, List, Sequence


class DataLoader:
    def __init__(
        self,
        dataset: Sequence,
        batch_sampler: Iterable[List[int]],
        collate_fn: Callable,
        num_workers: int = 2,
        prefetch: int = 4,
    ):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.collate_fn = collate_fn
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)

    def _make(self, indices: List[int]):
        return self.collate_fn([self.dataset[i] for i in indices])

    def __iter__(self) -> Iterator:
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = []
            it = iter(self.batch_sampler)
            try:
                for _ in range(self.prefetch):
                    pending.append(pool.submit(self._make, next(it)))
            except StopIteration:
                pass
            while pending:
                fut = pending.pop(0)
                try:
                    pending.append(pool.submit(self._make, next(it)))
                except StopIteration:
                    pass
                yield fut.result()

    def __len__(self) -> int:
        return len(self.batch_sampler)  # type: ignore[arg-type]
