"""Datasets (port of paddle_tpu's `io/dataset.py`): the map-style
`Dataset`, `IterableDataset`, `TensorDataset`, the compositions
`ComposeDataset` (zip), `ChainDataset` (iterables one after another) and
`ConcatDataset`, `Subset`, and `random_split`, which draws its
permutation from numpy's global generator as the JAX function does."""
from __future__ import annotations

import bisect

import numpy as np

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Item i is the tuple of every array's row i (arrays share dim 0)."""

    def __init__(self, tensors):
        self.tensors = list(tensors)
        if len({t.shape[0] for t in self.tensors}) != 1:
            raise ValueError("TensorDataset: all tensors must share dim 0")

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    """Item i is the concatenation of every dataset's item i (a sample
    that is a list or tuple contributes its fields)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        if len({len(d) for d in self.datasets}) != 1:
            raise ValueError("ComposeDataset: datasets must have equal "
                             "length")

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            if isinstance(sample, (list, tuple)):
                out.extend(sample)
            else:
                out.append(sample)
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum(
            [len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = 0 if ds_idx == 0 else self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Disjoint `Subset`s of the given lengths over one permutation."""
    total = sum(lengths)
    if total != len(dataset):
        raise ValueError("random_split: lengths must sum to the dataset's "
                         "size")
    perm = np.random.permutation(total)
    out, off = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[off:off + n].tolist()))
        off += n
    return out
