"""DataLoader (port of paddle_tpu's `io/dataloader.py`, in-process only):
batches of a Dataset, stacked into numpy arrays. `shuffle` draws each
epoch's order from numpy's global generator (reseeded by `seed`), as the
JAX package's RandomSampler does."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["DataLoader", "default_collate_fn"]


def default_collate_fn(batch):
    """Stack a list of samples into batched numpy arrays, recursing into
    tuples, lists and dicts."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return np.stack([s.cpu().numpy() for s in batch])
    if isinstance(sample, (list, tuple)):
        return type(sample)(default_collate_fn(list(s)) for s in zip(*batch))
    if isinstance(sample, dict):
        return {k: default_collate_fn([s[k] for s in batch]) for k in sample}
    return np.stack([np.asarray(s) for s in batch])


class DataLoader:
    def __init__(self, dataset, batch_size=1, shuffle=False, drop_last=False,
                 num_workers=0):
        if num_workers:
            raise NotImplementedError("DataLoader worker processes are not "
                                      "ported to paddle_tpu_torch")
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.drop_last = bool(drop_last)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def __iter__(self):
        n = len(self.dataset)
        order = np.random.permutation(n) if self.shuffle else np.arange(n)
        for i in range(len(self)):
            idx = order[i * self.batch_size:(i + 1) * self.batch_size]
            yield default_collate_fn([self.dataset[int(j)] for j in idx])
