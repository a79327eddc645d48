"""paddle.distributed for the training slice: one device (see
`fleet.strategy`), and its one-device `build_mesh`."""
from . import fleet
from .mesh import build_mesh, get_mesh, set_mesh

__all__ = ["fleet", "build_mesh", "get_mesh", "set_mesh"]
