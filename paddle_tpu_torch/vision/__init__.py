"""paddle.vision (port of paddle_tpu's `vision/`): the model zoo's LeNet
and ResNet family (`vision.models`), the numpy image transforms
(`vision.transforms`), the local-file datasets and folders
(`vision.datasets`) and image loading (`vision.image`). The detection ops
(`vision.ops`) are not ported (ROADMAP queue 1 item 9)."""
from . import datasets, image, models, transforms
from .image import get_image_backend, image_load, set_image_backend

__all__ = ["datasets", "models", "transforms", "image", "get_image_backend",
           "image_load", "set_image_backend"]
