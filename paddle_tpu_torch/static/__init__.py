"""paddle.static for the training slice: `InputSpec`, a plain record."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["InputSpec"]


@dataclasses.dataclass
class InputSpec:
    """One input's (shape, dtype, name); None dims are any size."""
    shape: Tuple[Optional[int], ...]
    dtype: str = "float32"
    name: Optional[str] = None

    def __post_init__(self):
        self.shape = tuple(self.shape)
        self.dtype = str(self.dtype)
