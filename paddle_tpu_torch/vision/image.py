"""paddle.vision.image (port of paddle_tpu's `vision/image.py`): image
backend selection and `image_load`. The backends are 'numpy' (raw arrays,
.npy / .npz) always and 'pil' where Pillow is importable; 'cv2' raises
the ValueError paddle gives for an unknown backend, as in the JAX
package."""
from __future__ import annotations

import os

import numpy as np

__all__ = ["set_image_backend", "get_image_backend", "image_load"]

_BACKEND = "numpy"


def set_image_backend(backend):
    global _BACKEND
    if backend not in ("numpy", "pil"):
        raise ValueError(
            f"Expected backend are one of ['numpy', 'pil'], but got "
            f"{backend}")
    _BACKEND = backend


def get_image_backend():
    return _BACKEND


def image_load(path, backend=None):
    """Load an image file with `backend` (default: the current one):
    'numpy' reads .npy / .npz into an ndarray, 'pil' opens the file with
    Pillow."""
    backend = backend or _BACKEND
    ext = os.path.splitext(path)[1].lower()
    if backend == "numpy":
        if ext == ".npy":
            return np.load(path)
        if ext == ".npz":
            data = np.load(path)
            return data[list(data.files)[0]]
        raise ValueError(
            f"image_load backend 'numpy' reads .npy/.npz, got {ext!r}; "
            "set_image_backend('pil') for image formats")
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            "image_load backend 'pil' needs Pillow (or use the 'numpy' "
            "backend with .npy/.npz)")
    return Image.open(path)
