"""Host-side minibatch iterators (numpy), as in ``torch_rechub_tpu/utils/data.py``."""

from __future__ import annotations

import numpy as np


class SeqLoader:
    """Minibatch iterator over (seq_tokens, seq_positions, seq_time_diffs, target) tuples.

    numpy counterpart of the reference ``SeqDataset`` + DataLoader; yields
    4-tuples of numpy arrays in that order.  The trainer moves each batch to
    its device.
    """

    def __init__(self, seq_tokens, seq_positions, targets, seq_time_diffs, batch_size=32, shuffle=False, seed=0):
        self.seq_tokens = np.asarray(seq_tokens)
        self.seq_positions = np.asarray(seq_positions)
        self.targets = np.asarray(targets).reshape(-1)
        self.seq_time_diffs = np.asarray(seq_time_diffs)
        n = len(self.targets)
        if not (len(self.seq_tokens) == n and len(self.seq_positions) == n and len(self.seq_time_diffs) == n):
            raise ValueError(f"SeqLoader: {len(self.seq_tokens)} token rows, {len(self.seq_positions)} position rows, {len(self.seq_time_diffs)} time rows for {n} targets")
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

    def __len__(self):
        return (self.n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = np.arange(self.n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
            self._epoch += 1
        for start in range(0, self.n, self.batch_size):
            idx = order[start:start + self.batch_size]
            yield (self.seq_tokens[idx], self.seq_positions[idx], self.seq_time_diffs[idx], self.targets[idx])
