"""TensorDataset (port of paddle_tpu's `io/dataset.py`)."""
from __future__ import annotations

__all__ = ["Dataset", "TensorDataset"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


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
