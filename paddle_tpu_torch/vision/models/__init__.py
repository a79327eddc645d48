"""The model zoo (port of paddle_tpu's `vision/models/`): LeNet and
ResNet. VGG and MobileNet are not ported (ROADMAP queue 1 item 9)."""
from .lenet import LeNet
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18,
                     resnet34, resnet50, resnet101, resnet152)

__all__ = ["LeNet", "ResNet", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152", "BasicBlock", "BottleneckBlock"]
