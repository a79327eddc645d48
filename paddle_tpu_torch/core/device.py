"""Device resolution for the port's entry points.

Every entry point (`DecodeEngine`, `load_for_decode`, `GPTDecoder`,
`params_from_numpy`, the serve daemon) runs on the GPU unless the caller
asks for the CPU. Without a GPU the default raises: the port never
quietly carries on on the CPU, where its kernels do not run.
"""
from __future__ import annotations

import torch


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
