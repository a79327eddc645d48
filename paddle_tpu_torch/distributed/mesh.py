"""Device meshes (port of paddle_tpu's `distributed/mesh.py`), on one
device.

`build_mesh(shape, axis_names, devices)` takes the JAX package's call and
returns a `Mesh` whose axes all have size 1: code that reads
``mesh.shape.get("dp", 1)`` or passes a one-device mesh to
`compile_train_step` (benchmarks/run.py's configs 2 and 3) runs
unchanged. A mesh over more than one device, or with an axis larger than
1, needs collectives over NCCL (ROADMAP queue 1 item 7) and raises
`NotImplementedError`. `named_sharding` is not ported.
"""
from __future__ import annotations

import collections
import math
from typing import Optional, Sequence

import numpy as np

from ..core.device import default_device, resolve_device

__all__ = ["Mesh", "build_mesh", "set_mesh", "get_mesh"]

_MULTI = ("only a one-device mesh is ported to paddle_tpu_torch; more "
          "devices need NCCL collectives (ROADMAP queue 1 item 7)")


class Mesh:
    """One device under named axes of size 1: `shape` ({axis: size}, in
    axis order), `axis_names`, `size` and `devices` (an array of torch
    devices shaped by the sizes), as a JAX mesh has them."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = collections.OrderedDict(zip(self.axis_names,
                                                 devices.shape))
        self.size = int(devices.size)

    @property
    def device(self):
        """The mesh's one device."""
        return self.devices.flat[0]

    def __repr__(self):
        return f"Mesh({dict(self.shape)}, device={self.device})"


def build_mesh(shape: Optional[dict] = None,
               axis_names: Sequence[str] = ("dp",), devices=None) -> Mesh:
    """A `Mesh` from {axis: size} (a size of -1 is inferred) over
    `devices` (default: the default device). Every size must come to 1
    and `devices` hold one device; anything larger raises
    `NotImplementedError`."""
    devices = [resolve_device(d) for d in devices] if devices is not None \
        else [default_device()]
    n = len(devices)
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("shape required for multi-axis mesh")
        shape = {axis_names[0]: n}
    names, sizes = list(shape), list(shape.values())
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = n // known
    if n != 1 or math.prod(sizes) != 1:
        raise NotImplementedError(
            f"build_mesh({dict(zip(names, sizes))}) over {n} devices: "
            f"{_MULTI}")
    arr = np.empty(len(sizes) * (1,), dtype=object)
    arr.flat[0] = devices[0]
    return Mesh(arr, names)


_current_mesh = [None]


def set_mesh(mesh: Mesh):
    _current_mesh[0] = mesh


def get_mesh() -> Optional[Mesh]:
    return _current_mesh[0]
