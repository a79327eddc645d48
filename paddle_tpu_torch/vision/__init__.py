"""paddle.vision (port of paddle_tpu's `vision/`): the model zoo's LeNet
and ResNet family (`vision.models`). Transforms, datasets, image I/O and
the detection ops are not ported (ROADMAP queue 1 items 9-10)."""
from . import models

__all__ = ["models"]
