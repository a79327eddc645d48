"""paddle.io for the training slice: datasets, the DataLoader, and
format-2 checkpoint directories (`io.checkpoint`)."""
from . import checkpoint
from .dataloader import DataLoader, default_collate_fn
from .dataset import Dataset, TensorDataset

__all__ = ["Dataset", "TensorDataset", "DataLoader", "default_collate_fn",
           "checkpoint"]
