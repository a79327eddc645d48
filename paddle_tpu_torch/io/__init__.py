"""paddle.io for the training slice."""
from .dataloader import DataLoader, default_collate_fn
from .dataset import Dataset, TensorDataset

__all__ = ["Dataset", "TensorDataset", "DataLoader", "default_collate_fn"]
