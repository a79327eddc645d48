"""Tensors to host numpy arrays and back, bit for bit, for the files the
port shares with the JAX package (`framework.save` / `load`, the
`Model.save` pair, `io.checkpoint`).

bf16 has no numpy dtype of its own. The JAX package writes an
`ml_dtypes.bfloat16` array; `to_numpy` does the same when `ml_dtypes` is
importable, so that the JAX package reads the file. Where it is not,
`to_numpy` returns the raw bits as a structured array with one uint16
field named ``bfloat16`` (`BF16_BITS`): plain numpy, which any numpy
unpickles and `to_tensor` reads back as bf16, but which the JAX package
does not take as bf16. `to_tensor` also takes the void ``V2`` array that
`np.load` gives for a bf16 ``.npy`` (descr ``'<V2'``) when told its
dtype.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["BF16_BITS", "to_numpy", "to_tensor", "dtype_name", "bf16_numpy"]

BF16_BITS = np.dtype([("bfloat16", "<u2")])


def bf16_numpy():
    """`ml_dtypes.bfloat16` as a numpy dtype, or None without ml_dtypes."""
    try:
        import ml_dtypes
    except ImportError:
        return None
    return np.dtype(ml_dtypes.bfloat16)


def dtype_name(a: np.ndarray) -> str:
    """The JAX package's name of an array's dtype ("float32", "bfloat16",
    "int32", ...), for either bf16 encoding of `to_numpy`."""
    return "bfloat16" if a.dtype == BF16_BITS else str(a.dtype)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of `t` (detached); bf16 as described above."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy().copy()
    bits = t.contiguous().view(torch.int16).numpy().view(np.uint16)
    bf16 = bf16_numpy()
    return bits.view(bf16).copy() if bf16 is not None \
        else bits.view(BF16_BITS).copy()


def _is_bf16(a: np.ndarray, dtype) -> bool:
    return (a.dtype == BF16_BITS or a.dtype.name == "bfloat16"
            or (dtype == "bfloat16" and a.dtype.kind == "V"
                and a.dtype.itemsize == 2))


def to_tensor(a, device, dtype=None) -> torch.Tensor:
    """`a` (a numpy array or scalar) as a tensor on `device`, bit for bit.
    `dtype` names the array's dtype where numpy cannot (a ``V2`` array
    read from a bf16 ``.npy``)."""
    a = np.asarray(a)
    if _is_bf16(a, dtype):
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)
