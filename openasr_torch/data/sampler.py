"""Batch samplers: budget-packed (speech) and fixed-count (text).

Counterpart of `BudgetBatchSampler`, `TimeBasedSampler` and
`FrameBasedSampler` in openasr_tpu/data/sampler.py: greedily pack
length-sorted samples until a cumulative `feat_length` budget is met
(samples for wave datasets, frames for feature datasets), with the batch
size divisible by the data-parallel degree.  With `shuffle`, every pass
permutes the whole batches with one seeded `np.random.RandomState`, so the
order matches the JAX package's epoch for epoch.  `CountBatchSampler`
(counterpart of the JAX one) cuts fixed-size batches of text lines and,
with `shuffle`, re-permutes the lines themselves every pass with its own
seeded `np.random.RandomState`, so the batches' contents match too.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np


class BudgetBatchSampler:
    """Pack batches until cumulative `key` (`feat_length`, or the phone
    datasets' `phone_length`) >= budget, batch size divisible by
    `divisible_by`."""

    def __init__(
        self,
        dataset: Sequence[dict],
        budget: float,
        key: str = "feat_length",
        divisible_by: int = 1,
        shuffle: bool = False,
        seed: int = 0,
    ):
        self.shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        batches: List[List[int]] = []
        batch: List[int] = []
        acc = 0.0
        for idx in range(len(dataset)):
            batch.append(idx)
            acc += float(dataset[idx][key])
            if acc >= budget and len(batch) % divisible_by == 0:
                batches.append(batch)
                batch = []
                acc = 0.0
        if batch:
            # trim the ragged tail so it stays divisible
            keep = len(batch) // divisible_by * divisible_by
            if keep:
                batches.append(batch[len(batch) - keep :])
        self.batches = batches

    def __iter__(self) -> Iterator[List[int]]:
        order = np.arange(len(self.batches))
        if self.shuffle:
            self._rng.shuffle(order)
        for i in order:
            yield self.batches[i]

    def __len__(self) -> int:
        return len(self.batches)


class TimeBasedSampler(BudgetBatchSampler):
    """Budget in cumulative samples (online wave datasets)."""

    def __init__(self, dataset, duration=200, ngpu=1, shuffle=False, seed=0):
        super().__init__(dataset, budget=duration, divisible_by=max(ngpu, 1),
                         shuffle=shuffle, seed=seed)


class FrameBasedSampler(BudgetBatchSampler):
    """Budget in cumulative frames (offline feature datasets)."""

    def __init__(self, dataset, frames=200, ngpu=1, shuffle=False, seed=0):
        super().__init__(dataset, budget=frames, divisible_by=max(ngpu, 1),
                         shuffle=shuffle, seed=seed)


class CountBatchSampler:
    """Batches of `batch_size` indices of `n` (the last one short unless
    `drop_last`).  With `shuffle`, each pass draws a new permutation of the
    samples before cutting, so every epoch forms new batches."""

    def __init__(self, n: int, batch_size: int, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False):
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.RandomState(seed)

    def __iter__(self) -> Iterator[List[int]]:
        idx = np.arange(self.n)
        if self.shuffle:
            self._rng.shuffle(idx)
        bs = self.batch_size
        for i in range(len(self)):
            yield list(idx[i * bs:(i + 1) * bs])

    def __len__(self) -> int:
        bs = self.batch_size
        return self.n // bs if self.drop_last else (self.n + bs - 1) // bs
