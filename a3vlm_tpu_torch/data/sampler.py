"""Type-homogeneous distributed sampler (reference model/accessory/data/
alpaca.py:246-328): every global batch (batch_size x num_replicas x
acc_grad) is drawn from ONE modality group, groups are truncated to whole
global batches, and mid-epoch resume is supported via ``start_iter``."""

from __future__ import annotations

import copy
from typing import Iterator, Optional

import numpy as np


class FinetuneDistSampler:
    def __init__(
        self,
        dataset,
        num_replicas: Optional[int] = None,
        rank: Optional[int] = None,
        shuffle: bool = True,
        seed: int = 0,
        batch_size: Optional[int] = None,
        acc_grad: int = 1,
    ):
        if (
            num_replicas is None
            or rank is None
            or rank >= num_replicas
            or rank < 0
        ):
            raise ValueError(
                f"Invalid num_replicas ({num_replicas}) or rank ({rank})"
            )
        assert batch_size is not None
        self.batch_size = batch_size
        self.dataset = dataset
        self.num_replicas = num_replicas
        self.rank = rank
        self.acc_grad = acc_grad
        self.epoch = 0
        self.start_iter = 0

        group_indices = dataset.groups()
        global_bsz = batch_size * num_replicas * acc_grad
        len_groups = [len(g) // global_bsz * global_bsz for g in group_indices]
        group_indices = [
            g[:n] for g, n in zip(group_indices, len_groups)
        ]
        group_n_batch = [len(g) // batch_size for g in group_indices]
        assert all(n % num_replicas == 0 for n in group_n_batch)
        n_total_batch = sum(group_n_batch)
        assert n_total_batch % num_replicas == 0

        self.group_indices = group_indices
        self.total_size = n_total_batch * batch_size
        self.num_samples = self.total_size // num_replicas
        self.shuffle = shuffle
        self.seed = seed

    def __iter__(self) -> Iterator[int]:
        global_batch_size = self.batch_size * self.num_replicas * self.acc_grad
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            groups = copy.deepcopy(self.group_indices)
            global_batched = [
                g[i : i + global_batch_size]
                for g in groups
                for i in range(0, len(g), global_batch_size)
            ]
            rng.shuffle(global_batched)
            indices = [i for batch in global_batched for i in batch]
        else:
            indices = [i for g in self.group_indices for i in g]
        assert len(indices) == self.total_size

        own = []
        for start in range(
            self.rank * self.batch_size,
            len(indices),
            self.num_replicas * self.batch_size,
        ):
            own += indices[start : start + self.batch_size]
        assert len(own) == self.num_samples

        if self.start_iter * self.batch_size > len(own):
            own = []
        else:
            own = own[self.start_iter * self.batch_size:]
        return iter(own)

    def __len__(self) -> int:
        return self.num_samples

    def set_epoch(self, epoch: int, start_iter: int = 0) -> None:
        self.epoch = epoch
        self.start_iter = start_iter
