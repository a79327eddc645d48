"""paddle.distributed for the training slice (one device; see
`fleet.strategy`)."""
from . import fleet

__all__ = ["fleet"]
