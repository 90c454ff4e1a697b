"""Batch composition: row-budget packing + group-aware interleaving.

The reference's SplitGatherBatchSampler (dataset/base.py:233-285) interleaves
per-video groups so one video's chunks never share a batch; its plain path
shuffles entries into fixed ENTRY-count batches with data-dependent row
counts. TPU batches need a fixed ROW count instead, so both samplers here
pack entries greedily into a static `row_capacity` budget (padding fills the
remainder); batches with fewer than 2 distinct video groups are dropped (the
out-of-group negative sampler needs >= 2 groups, like the reference's
guarantee at dataset/base.py:273-278).
"""
from __future__ import annotations

import random
from collections import defaultdict
from typing import Dict, Iterator, List


class RowBudgetBatcher:
    """Greedy row-budget packing of merged entries."""

    def __init__(self, dataset, row_capacity: int, shuffle: bool, seed: int = 0,
                 drop_single_group: bool = True, max_entries: int = 0):
        self.dataset = dataset
        self.row_capacity = row_capacity
        self.shuffle = shuffle
        self.rng = random.Random(seed)
        self.drop_single_group = drop_single_group
        # >0: also cap the ENTRY (video) count per batch — required by the
        # deduplicated-video collate whose group array has a static capacity
        self.max_entries = max_entries
        # eval: order entries by estimated video length so batches pad to
        # their LOCAL maximum (with the collate's buckets, most batches land
        # in a tight bucket instead of the global cap). Metrics are per-query
        # and order-independent, so this is value-neutral.
        self.sort_by_length = False
        self._epoch = 0
        max_rows = dataset.max_group_size()
        if max_rows > row_capacity:
            raise ValueError(
                f"row_capacity {row_capacity} < largest group ({max_rows} rows); "
                "raise --row_capacity or set max_gather_size"
            )

    def _n_rows(self, idx: int) -> int:
        return len(self.dataset.merged_data[idx]["video_id"])

    def __iter__(self) -> Iterator[List[int]]:
        order = list(range(len(self.dataset)))
        if self.shuffle:
            self.rng.seed(self._epoch)
            self.rng.shuffle(order)
        elif self.sort_by_length and hasattr(self.dataset, "estimated_length"):
            order.sort(key=self.dataset.estimated_length)
        self._epoch += 1
        batch: List[int] = []
        used = 0
        for idx in order:
            n = self._n_rows(idx)
            if used + n > self.row_capacity or (
                self.max_entries and len(batch) >= self.max_entries
            ):
                if self._valid(batch):
                    yield batch
                batch, used = [], 0
            batch.append(idx)
            used += n
        if batch and self._valid(batch):
            yield batch

    def _valid(self, batch: List[int]) -> bool:
        if not self.drop_single_group:
            return bool(batch)
        vids = {self.dataset.merged_data[i]["video_id"][0] for i in batch}
        return len(vids) >= 2

    def __len__(self) -> int:
        total = sum(self._n_rows(i) for i in range(len(self.dataset)))
        return max(total // self.row_capacity, 1)


class GroupAwareBatcher(RowBudgetBatcher):
    """Row-budget packing that never places two chunks of the same video in a
    batch (SplitGatherBatchSampler semantics for max_gather_size > 0)."""

    def __iter__(self) -> Iterator[List[int]]:
        groups: Dict[str, List[int]] = defaultdict(list)
        for idx, e in enumerate(self.dataset.merged_data):
            groups[e["video_id"][0]].append(idx)
        if self.shuffle:
            self.rng.seed(self._epoch)
            for lst in groups.values():
                self.rng.shuffle(lst)
        self._epoch += 1

        iters = {vid: iter(lst) for vid, lst in groups.items()}
        vids = list(iters.keys())
        batch: List[int] = []
        used = 0
        in_batch: set = set()
        while iters:
            if self.shuffle:
                self.rng.shuffle(vids)
            progressed = False
            for vid in list(vids):
                if vid not in iters or vid in in_batch:
                    continue
                try:
                    idx = next(iters[vid])
                except StopIteration:
                    del iters[vid]
                    vids.remove(vid)
                    continue
                n = self._n_rows(idx)
                if used + n > self.row_capacity:
                    if self._valid(batch):
                        yield batch
                    batch, used, in_batch = [], 0, set()
                batch.append(idx)
                in_batch.add(vid)
                used += n
                progressed = True
            if not progressed:
                # every remaining video already has a chunk in this batch:
                # flush so the next sweep can make progress
                if batch and self._valid(batch):
                    yield batch
                batch, used, in_batch = [], 0, set()
                if not iters:
                    break
        if batch and self._valid(batch):
            yield batch
