"""DataModule: bundles the train / val0-2 / test loaders with the reference's
strided samplers.

An own copy of muvo_tpu/data/datamodule.py (a test holds the samplers
equal). Counterpart of reference muvo/data/dataset.py:19-141 (DataModule):
three validation datasets (val0/val1/val2), three strided test samplers
over the train split, shared batch size and sequence length from the
config.
"""

from __future__ import annotations

from typing import List

from muvo_tpu_torch.data.dataset import make_dataset
from muvo_tpu_torch.data.loader import DataLoader


def make_val_samplers(lengths: List[int]) -> List[range]:
    """The reference's three strided validation samplers
    (muvo/data/dataset.py:44-52)."""
    return [
        range(0, lengths[0], 50),
        range(min(1500, max(0, lengths[1] - 1)), lengths[1], 50),
        range(min(3000, max(0, lengths[2] - 1)), lengths[2], 50),
    ]


def make_test_samplers(n: int) -> List[range]:
    """The reference's three strided test samplers over the train split
    (muvo/data/dataset.py:54-68)."""
    return [
        range(0, n, 900),
        range(min(1500, max(0, n - 1)), n, 600),
        range(0, n, 150),
    ]


class DataModule:
    def __init__(self, cfg, dataset_root: str = None):
        self.cfg = cfg
        self.batch_size = cfg.BATCHSIZE
        self.sequence_length = cfg.RECEPTIVE_FIELD + cfg.FUTURE_HORIZON
        self.dataset_root = dataset_root or cfg.DATASET.DATAROOT
        self.train_dataset = None
        self.val_datasets: List = []
        self.test_dataset = None

    def setup(self):
        cfg = self.cfg
        self.train_dataset = make_dataset(cfg, "train", self.sequence_length)
        self.val_datasets = [
            make_dataset(cfg, f"val{i}", self.sequence_length)
            for i in range(3)
        ]
        self.test_dataset = make_dataset(cfg, "train", self.sequence_length)

        self.val_samplers = make_val_samplers(
            [len(ds) for ds in self.val_datasets])
        self.test_samplers = make_test_samplers(len(self.test_dataset))

    def train_dataloader(self, num_workers: int = 1) -> DataLoader:
        return DataLoader(self.train_dataset, self.batch_size, shuffle=True,
                          drop_last=True, num_workers=num_workers)

    def val_dataloaders(self) -> List[DataLoader]:
        return [
            DataLoader(ds, self.batch_size, shuffle=False, sampler=sampler,
                       drop_last=True)
            for ds, sampler in zip(self.val_datasets, self.val_samplers)
        ]

    def test_dataloaders(self) -> List[DataLoader]:
        return [
            DataLoader(self.test_dataset, self.batch_size, shuffle=False,
                       sampler=sampler, drop_last=True)
            for sampler in self.test_samplers
        ]
