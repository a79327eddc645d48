"""paddle.seed, get_rng_state and set_rng_state on torch.Generators.

`seed(s)` reseeds the generator that parameter initializers draw from
(`generator()`, a CPU `torch.Generator`, so one seed gives the same weights
whichever device the layer lives on), PyTorch's own per-device generators
(dropout masks), and numpy's global generator (the DataLoader's shuffle),
as the JAX package's `core/random.py` reseeds its key and numpy. The two
packages draw different numbers from the same seed: tests carry weights
across as numpy arrays instead.
"""
from __future__ import annotations

import numpy as np
import torch

_GENERATOR = torch.Generator()


def seed(s: int) -> torch.Generator:
    """Reseed every generator the port draws from; returns the
    initializers' generator."""
    s = int(s)
    _GENERATOR.manual_seed(s)
    torch.manual_seed(s)
    np.random.seed(s % (2 ** 32))
    return _GENERATOR


def generator() -> torch.Generator:
    """The CPU generator parameter initializers draw from."""
    return _GENERATOR


def get_rng_state():
    """The state of every generator `seed` reseeds: the initializers',
    torch's CPU and CUDA ones and numpy's; `set_rng_state` restores it."""
    state = {"initializer": _GENERATOR.get_state(),
             "cpu": torch.get_rng_state(), "numpy": np.random.get_state()}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        state["cuda"] = torch.cuda.get_rng_state_all()
    return state


def set_rng_state(state):
    _GENERATOR.set_state(state["initializer"])
    torch.set_rng_state(state["cpu"])
    np.random.set_state(state["numpy"])
    if "cuda" in state:
        torch.cuda.set_rng_state_all(state["cuda"])


def get_cuda_rng_state():
    """paddle's name for the device generators' state: `get_rng_state`
    (torch's CUDA generators with the rest)."""
    return get_rng_state()


def set_cuda_rng_state(state):
    set_rng_state(state)
