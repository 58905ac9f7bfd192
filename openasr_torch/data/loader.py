"""Prefetching data loader: sampler + collate -> background-threaded batches.

Counterpart of openasr_tpu/data/loader.py.  Ark reads are IO-bound NumPy
work, so a thread pool with a bounded prefetch queue suffices; batches come
out as NumPy dicts.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, List, Sequence


class DataLoader:
    """`rank`/`world` make the loader data-parallel: every rank builds the
    same batch plan (same manifest, same sampler seed) and loads only its
    contiguous row slice of each planned batch, rows [r B/w, (r+1) B/w).
    The sampler's divisibility is the world size, so B divides; each rank
    pads its slice by itself, and the solver reconciles the shapes
    (`parallel.reconcile_batch`)."""

    def __init__(
        self,
        dataset: Sequence,
        batch_sampler: Iterable[List[int]],
        collate_fn: Callable,
        num_workers: int = 2,
        prefetch: int = 4,
        rank: int = 0,
        world: int = 1,
    ):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.collate_fn = collate_fn
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.rank = rank
        self.world = max(1, world)

    def _make(self, indices: List[int]):
        if self.world > 1:
            assert len(indices) % self.world == 0, (
                f"batch of {len(indices)} not divisible by world={self.world}"
                " (pass the global data-axis size as the sampler's ngpu)"
            )
            k = len(indices) // self.world
            indices = indices[self.rank * k:(self.rank + 1) * k]
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
