"""The inputs of each outer step, re-derived from the seeds alone.

What the distill window is handed besides the synthetic set: which
trajectory and start epoch each segment takes, the minibatch indices of
each inner step and the dropout seeds of each inner step.  These follow
the published algorithm (``distill.py:450-476`` of the paper's code, the
file shuffle and cursor walk, one ``RandomState`` for both; a fresh
randperm prefix per inner step; one 62-bit seed pair per inner step from a
``torch.Generator`` at the run's seed), so the reference computes them
itself rather than reading them from the program.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np
import torch


def segments(n_files: int, experts: int, snapshots: int, max_start_epoch: int,
             expert_epochs: int, seed: int) -> Iterator[Tuple[int, int, int]]:
    """(file index as listed, expert, start epoch) of each segment."""
    rng = np.random.RandomState(seed)
    order = list(range(n_files))

    def shuffle():
        perm = rng.permutation(len(order))
        order[:] = [order[i] for i in perm]

    shuffle()
    file_idx = expert_idx = 0
    while True:
        f, e = order[file_idx], expert_idx
        expert_idx += 1
        if expert_idx == experts:
            expert_idx = 0
            file_idx += 1
            if file_idx == n_files:
                file_idx = 0
                shuffle()
        hi = max(1, min(max_start_epoch, snapshots - expert_epochs))
        yield f, e, int(rng.randint(0, hi))


def minibatches(rng: np.random.RandomState, n: int, mb: int,
                steps: int) -> np.ndarray:
    """(steps, min(mb, n)) indices: a fresh permutation's prefix per step."""
    m = min(mb, n)
    return np.stack([rng.permutation(n)[:m] for _ in range(steps)])


class DropoutSeeds:
    """(image, text) seeds of each inner step, ``steps`` per outer step."""

    def __init__(self, seed: int):
        self.gen = torch.Generator().manual_seed(int(seed))

    def draw(self, steps: int) -> List[Tuple[int, int]]:
        s = torch.randint(0, 2 ** 62, (steps, 2), generator=self.gen)
        return [tuple(int(v) for v in row) for row in s]


def batch_rows(pool: int, batch: int, seed: int, epoch: int) -> List[np.ndarray]:
    """The rows of each batch of one shuffled epoch over a pool: a
    ``RandomState(seed + epoch)`` shuffle, cut into ``batch`` rows."""
    idx = np.arange(pool)
    np.random.RandomState(seed + epoch).shuffle(idx)
    return [idx[i:i + batch] for i in range(0, pool, batch)]
