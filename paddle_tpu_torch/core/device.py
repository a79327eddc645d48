"""Device resolution for the port's entry points.

Every entry point (`DecodeEngine`, `load_for_decode`, `GPTDecoder`,
`params_from_numpy`, the serve daemon, the training layers and
`hapi.Model.prepare`) runs on the GPU unless the caller asks for the CPU.
Without a GPU the default raises: the port never quietly carries on on the
CPU, where its kernels do not run.

`set_device` is paddle's process-wide default device: the training layers
create their parameters on it and `Model.prepare` trains on it. Until it
is called the default is ``cuda``.
"""
from __future__ import annotations

import torch

_DEFAULT = [None]       # set_device's choice; None -> cuda


def resolve_device(device=None) -> torch.device:
    """`None` -> ``cuda``; a CUDA device raises when CUDA is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available "
            f"(torch {torch.__version__}, cuda {torch.version.cuda}); "
            f"pass device='cpu' to run the plain PyTorch versions on the "
            f"CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: want cuda or cpu")
    return dev


def set_device(device="gpu") -> torch.device:
    """paddle.set_device: ``"gpu"`` (the default), ``"gpu:N"``,
    ``"cuda[:N]"`` or ``"cpu"``. A GPU device raises when there is none."""
    dev = resolve_device(str(device).replace("gpu", "cuda"))
    _DEFAULT[0] = dev
    return dev


def get_device() -> torch.device:
    """The default device: `set_device`'s choice, else ``cuda`` (which
    raises when there is no GPU)."""
    return resolve_device(_DEFAULT[0])
