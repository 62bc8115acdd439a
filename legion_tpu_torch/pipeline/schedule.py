"""Train/valid/test step scheduling.

Replicates the reference coordinator's schedule exactly
(ipc_service.cu:60-132, 213-253):

  - train_step = (min over partitions of train set size - 1) // batch
    (drops the last partial batch);
  - valid/test use 512-seed steps: steps = (max size - 1) // 512 + 1, and a
    per-partition batch size of (size - 1) // steps + 1 so every partition
    finishes in the same number of steps;
  - each epoch interleaves train then valid; test runs once at the end;
  - max_step = (train_step + valid_step) * epochs + test_step.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Sequence, Tuple


class Mode(enum.IntEnum):
    # system_config.cuh mode ids
    TRAIN = 0
    VALID = 1
    TEST = 2


@dataclass(frozen=True)
class Schedule:
    train_step: int
    valid_step: int
    test_step: int
    epochs: int
    train_batch_size: int
    valid_batch_sizes: Tuple[int, ...]
    test_batch_sizes: Tuple[int, ...]

    @classmethod
    def build(cls, train_sizes: Sequence[int], valid_sizes: Sequence[int],
              test_sizes: Sequence[int], batch_size: int, epochs: int,
              eval_batch_size: int = 512) -> "Schedule":
        min_train = min(train_sizes)
        train_step = (min_train - 1) // batch_size
        assert train_step > 0, (
            f"batch_size {batch_size} too large for smallest partition "
            f"({min_train} seeds)")
        max_valid = max(valid_sizes)
        valid_step = (max_valid - 1) // eval_batch_size + 1
        valid_bs = tuple((s - 1) // valid_step + 1 for s in valid_sizes)
        max_test = max(test_sizes)
        test_step = (max_test - 1) // eval_batch_size + 1
        test_bs = tuple((s - 1) // test_step + 1 for s in test_sizes)
        return cls(train_step=train_step, valid_step=valid_step,
                   test_step=test_step, epochs=epochs,
                   train_batch_size=batch_size,
                   valid_batch_sizes=valid_bs, test_batch_sizes=test_bs)

    @property
    def max_step(self) -> int:
        return (self.train_step + self.valid_step) * self.epochs \
            + self.test_step

    def mode_of(self, global_batch_id: int) -> Mode:
        per_epoch = self.train_step + self.valid_step
        if global_batch_id < per_epoch * self.epochs:
            return Mode.TRAIN if (global_batch_id % per_epoch
                                  ) < self.train_step else Mode.VALID
        return Mode.TEST

    def local_id_of(self, global_batch_id: int) -> int:
        per_epoch = self.train_step + self.valid_step
        if global_batch_id < per_epoch * self.epochs:
            e = global_batch_id % per_epoch
            return e if e < self.train_step else e - self.train_step
        return (global_batch_id - per_epoch * self.epochs) % self.test_step
