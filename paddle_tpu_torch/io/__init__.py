"""paddle.io: datasets, samplers, the DataLoader (worker processes,
shared-memory transport), `device_prefetch`, format-2 checkpoint
directories (`io.checkpoint`) and model-file encryption (`io.crypto`)."""
from . import checkpoint, crypto
from .dataloader import (DataLoader, default_collate_fn, device_prefetch,
                         get_worker_info)
from .dataset import (ChainDataset, ComposeDataset, ConcatDataset, Dataset,
                      IterableDataset, Subset, TensorDataset, random_split)
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,
                      Sampler, SequenceSampler, SubsetRandomSampler,
                      WeightedRandomSampler)

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split",
           "Sampler", "SequenceSampler", "RandomSampler",
           "SubsetRandomSampler", "WeightedRandomSampler", "BatchSampler",
           "DistributedBatchSampler", "DataLoader", "default_collate_fn",
           "get_worker_info", "device_prefetch", "checkpoint", "crypto"]
